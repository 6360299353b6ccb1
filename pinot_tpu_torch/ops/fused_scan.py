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
entry tuples flattened into its schema) with a vmap rule, so
``torch.func.vmap`` over a planned closure reaches it with the physical
tensors and their batch dims: on CUDA the rule issues one launch of the
kernel's member-axis form (``pinot_fused_scan_batch``: each member its own
operand pointers, a shared operand the same address in every member, and
``[W, E, G]`` tables); on the CPU it runs the plain version once a member.
``BATCH_LAUNCHES`` counts member-axis launches by instantiation and
``BATCH_MEMBERS`` the members they carried.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
# members one member-axis launch takes (PINOT_MAX_MEMBERS in
# csrc/fused_scan.cu); a wider vmap launches once per chunk of members
MAX_MEMBERS = 8


def reset_counters() -> None:
    """Zero every launch counter of this module."""
    global LAUNCHES, MASK_WORDS_LAUNCHES, BATCH_MEMBERS
    LAUNCHES = MASK_WORDS_LAUNCHES = BATCH_MEMBERS = 0
    VARIANT_LAUNCHES.clear()
    BATCH_LAUNCHES.clear()

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
    device = key_t.device
    p = _ScanParams()
    p.n = n
    p.num_groups = num_groups
    streams = []  # what the vector loads read: (address, bits a row, packed)
    if key_bits:
        words = key_t.view(torch.int32) if key_t.dtype == torch.uint32 else key_t
        if words.dtype != torch.int32:
            raise ValueError(f"packed key words must be int32/uint32, got {key_t.dtype}")
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
    return p, order, f"{km}/{vm}/{'shared' if shared else 'global'}"


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
    # the library launches on the current device: make it the key's
    current = torch.cuda.current_device()
    with torch.cuda.device(device) if device.index not in (None, current) else contextlib.nullcontext():
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


def _launch_batch(members, num_groups: int) -> torch.Tensor:
    """ONE member-axis launch over W <= MAX_MEMBERS members, each given as
    (entries, key, key_bits, n, mask_words, code_pred) on one device, with
    one table shape and one instantiation; returns f64 [W, E, G]."""
    global LAUNCHES, MASK_WORDS_LAUNCHES, BATCH_MEMBERS
    lib = _library()
    W = len(members)
    E = len(members[0][0])
    device = members[0][1].device
    out = torch.zeros((W, E, num_groups), dtype=torch.int64, device=device)
    arr = (_ScanParams * W)()
    orders, variants = [], set()
    current = torch.cuda.current_device()
    with torch.cuda.device(device) if device.index not in (None, current) else contextlib.nullcontext():
        smem = _smem_optin(lib, torch.cuda.current_device())
        for w, (entries, key_t, key_bits, n, mask_words, code_pred) in enumerate(members):
            p, order, variant = build_params(entries, key_t, key_bits, n, num_groups, mask_words, code_pred, smem)
            arr[w] = p
            orders.append(order)
            variants.add(variant)
        if len(variants) != 1:
            raise ValueError(f"members of one launch resolve to different instantiations {sorted(variants)}")
        err = lib.pinot_fused_scan_batch(arr, W, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused scan member-axis launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    variant = variants.pop()
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] = VARIANT_LAUNCHES.get(variant, 0) + 1
    BATCH_LAUNCHES[variant] = BATCH_LAUNCHES.get(variant, 0) + 1
    BATCH_MEMBERS += W
    MASK_WORDS_LAUNCHES += members[0][4] is not None
    out = out.to(torch.float64)
    if all(o == sorted(o) for o in orders):
        return out
    return torch.stack([torch.stack(_entry_order(out[w], orders[w])) for w in range(W)])


# ---------------------------------------------------------------------------
# the custom op: the entry tuples flattened into a schema torch.library takes
# ---------------------------------------------------------------------------
def _flatten(entries):
    """(kinds, sum values, masks, limb counts, signs): limb count -1 for no
    plan; values only for the sum entries, in entry order."""
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
    return kinds, values, masks, limbs, signs


_KINDS = {c: k for k, c in _KIND_CODES.items()}


def _unflatten(kinds, values, masks, limbs, signs) -> List[Entry]:
    entries, vi = [], 0
    for kc, m, nl, sg in zip(kinds, masks, limbs, signs):
        kind = _KINDS[int(kc)]
        v = None
        if kind != "count":
            v = values[vi]
            vi += 1
        lp = None if nl < 0 else ((nl, bool(sg)) if kind == "int_sum" else nl)
        entries.append((kind, v, m, lp))
    return entries


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


def _scan_args(key, key_bits, kinds, values, masks, limbs, signs, mask_words, pred, pred_lo, pred_hi):
    """(entries, rows, code_pred) of one call, from the op's arguments."""
    entries = _unflatten(kinds, values, masks, limbs, signs)
    code_pred = None if pred is None else (pred, int(pred_lo), int(pred_hi))
    n = int(masks[0].shape[0]) if key_bits else int(key.shape[0])
    return entries, n, code_pred


@torch.library.custom_op("pinot_tpu_torch::fused_group_tables", mutates_args=())
def _fused_op(
    key: torch.Tensor, key_bits: int, num_groups: int, kinds: List[int], values: List[torch.Tensor],
    masks: List[torch.Tensor], limbs: List[int], signs: List[int], mask_words: Optional[torch.Tensor],
    pred: Optional[torch.Tensor], pred_lo: Optional[torch.Tensor], pred_hi: Optional[torch.Tensor],
) -> torch.Tensor:
    entries, n, code_pred = _scan_args(
        key, key_bits, kinds, values, masks, limbs, signs, mask_words, pred, pred_lo, pred_hi)
    return torch.stack(_scan(entries, key, key_bits, n, num_groups, mask_words, code_pred))


@_fused_op.register_fake
def _(key, key_bits, num_groups, kinds, values, masks, limbs, signs, mask_words, pred, pred_lo, pred_hi):
    return key.new_empty((len(kinds), num_groups), dtype=torch.float64)


_is_batched = torch._C._functorch.is_batchedtensor


def member_args(W: int, in_dims, key, key_bits, num_groups, kinds, values, masks, limbs, signs,
                mask_words, pred, pred_lo, pred_hi) -> List[tuple]:
    """The op's arguments for each of W members, from the physical tensors
    and their member dims under vmap.  A shared operand (dim None) is the
    same tensor for every member; a stacked one is made member-major and
    dense once, and member w takes its slice (a dense view)."""
    kd, _kb, _ng, _k, vd, md, _l, _s, wd, pd, lod, hid = in_dims
    dense = {}
    for t, d in [(key, kd), (mask_words, wd), (pred, pd), (pred_lo, lod), (pred_hi, hid),
                 *zip(values, vd), *zip(masks, md)]:
        if t is not None and d is not None and id(t) not in dense:
            dense[id(t)] = t.movedim(d, 0).contiguous()

    def mem(t, w):
        return dense[id(t)][w] if t is not None and id(t) in dense else t

    return [
        (mem(key, w), key_bits, num_groups, kinds, [mem(v, w) for v in values], [mem(m, w) for m in masks],
         limbs, signs, mem(mask_words, w), mem(pred, w), mem(pred_lo, w), mem(pred_hi, w))
        for w in range(W)
    ]


def _fused_vmap(info, in_dims, *args):
    """The op under torch.func.vmap.  CUDA: one member-axis launch a chunk
    of MAX_MEMBERS members and MAX_ENTRIES entries; CPU: the plain version
    once a member."""
    members = member_args(info.batch_size, in_dims, *args)
    if args[0].device.type != "cuda":
        return torch.stack([_fused_op(*a) for a in members]), 0
    launches = []
    for a in members:
        entries, n, code_pred = _scan_args(a[0], a[1], *a[3:])
        launches.append((entries, a[0], a[1], n, a[8], code_pred))
    num_groups = args[2]
    chunks = []
    for e0 in range(0, len(args[3]), MAX_ENTRIES):
        rows = [
            _launch_batch([(ent[e0:e0 + MAX_ENTRIES], *rest) for ent, *rest in launches[w0:w0 + MAX_MEMBERS]],
                          num_groups)
            for w0 in range(0, len(launches), MAX_MEMBERS)
        ]
        chunks.append(torch.cat(rows))
    return torch.cat(chunks, dim=1), 0


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
    kinds, values, masks, limbs, signs = _flatten(entries)
    out = _fused_op(key, key_bits, num_groups, kinds, values, masks, limbs, signs, mask_words, pred, lo, hi)
    return list(out.unbind(0))
