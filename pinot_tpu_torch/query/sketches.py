"""Sketch & distinct aggregations: DISTINCTCOUNT, DISTINCTCOUNTHLL, PERCENTILE.

Port of pinot_tpu/query/sketches.py.  Reference parity: pinot-core's sketch
family — DistinctCountAggregationFunction (exact, value sets),
DistinctCountHLLAggregationFunction (HyperLogLog registers),
PercentileEst/TDigest/KLL (quantile sketches).

All three are FIXED-SIZE tensor partials whose combine is elementwise, so
they ride the dense group tables and the cross-launch combines like SUM:

  * DISTINCTCOUNT (exact): a presence table over the column's code domain
    (dictionary ids, or range-offset raw ints).  Field "present"
    [.., domain] int32 0/1, combine = max (set union), final = row sum.
  * DISTINCTCOUNTHLL: HLL registers [.., m] int32, combine = max.  Hashes
    are precomputed on the host over the DICTIONARY (card hashes in all),
    or computed on the device with a murmur finalizer for raw numeric
    columns (``_device_hash_values``).
  * PERCENTILE (and the Est/TDigest names): an equi-width histogram over a
    table-global [lo, hi]; fields "hist" (add) and "lo"/"hi" (min/max).

The hashes and bin indices are bit-for-bit the JAX package's.  torch has
no uint32 shift on the CPU, so the 32-bit hash runs in int64 lanes: every
product is masked back to 32 bits (the int64 product wraps, and its low 32
bits are the uint32 product's) and only masked, non-negative values shift.

Binding: `get_agg_function` returns unbound singletons whose merge/final
are shape-agnostic (the reduce side); the planner calls
`with_args(literal_args)` then `bind_column(info)` for the device side
(planner.bind_aggs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.ops import segmented as ops
from pinot_tpu_torch.query.functions import _REGISTRY, AggFunction, register
from pinot_tpu_torch.query.transform import device_constant

# Grouped sketch tables (presence bitmaps, HLL registers, histograms) are
# capped at this many cells (groups x per-group width) — the
# numGroupsLimit-style memory valve.
MAX_PRESENCE_CELLS = 1 << 26

# The JAX package defaults log2m to 12 (Pinot's plain HLL default is 8);
# an explicit log2m literal gives Pinot's width.
_DEFAULT_LOG2M = 12
_DEFAULT_PERCENTILE_BINS = 2048

_MASK32 = 0xFFFFFFFF


def _check_cell_budget(fn_name: str, num_groups: int, width: int) -> None:
    cells = num_groups * width
    if cells > MAX_PRESENCE_CELLS:
        raise NotImplementedError(
            f"{fn_name} grouped table {num_groups}x{width} = {cells} cells exceeds "
            f"{MAX_PRESENCE_CELLS}; lower group-key cardinality, numGroupsLimit, "
            "or the sketch width (log2m / bins)"
        )


def _flat_cells(keys: torch.Tensor, width: int, codes: torch.Tensor) -> torch.Tensor:
    """keys * width + codes as int64 cell ids of a [groups, width] table."""
    return keys.to(torch.int64) * width + codes.to(torch.int64)


def masked_cells(mask: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """Cell ids with masked-off rows sent to cell 0.  A padding or NULL
    row's range offset can fall outside the table; JAX's scatter drops such
    an index, torch's raises, so masked rows (which add nothing) get a
    valid one."""
    return torch.where(mask, cells, torch.zeros((), dtype=cells.dtype, device=cells.device))


def _presence(mask, cells: torch.Tensor, num_cells: int) -> torch.Tensor:
    return (ops.group_count(mask, masked_cells(mask, cells), num_cells) > 0).to(torch.int32)


@dataclass(frozen=True)
class ColumnBinding:
    """What the planner knows about the aggregated column at plan time.

    kind is already alignment-resolved by planner.column_binding:
      "dict"   - dictionary codes are a SHARED key space across all segments
                 of the query (single segment, stacked table, or verified
                 equal fingerprints) — code-indexed partials merge directly.
      "rawint" - bounded int value range (table-global); partials index by
                 (value - base), aligned by construction.
      "raw"    - unbounded/float values; only hash-based sketches apply.
    """

    kind: str  # "dict" | "rawint" | "raw"
    domain: int = 0  # dictionary cardinality / int range width
    base: int = 0  # min value for rawint code normalization
    # host-side dictionary values (numeric np array or object array) for
    # hash precomputation; None for raw columns
    dict_values: Optional[np.ndarray] = None
    # column stats for histogram ranges
    min_value: Any = None
    max_value: Any = None


# ---------------------------------------------------------------------------
# Exact DISTINCTCOUNT
# ---------------------------------------------------------------------------
class DistinctCountFunction(AggFunction):
    """Exact distinct count over a bounded code domain (the planner feeds
    dictionary codes or range-offset ints: input_kind)."""

    name = "distinctcount"
    needs_codes = True
    needs_binding = True
    vector_fields = True
    fields = ("present",)
    input_kind = "codes"

    def __init__(self, domain: int = 0, base: int = 0, input_kind: str = "codes"):
        self.domain = domain
        self.base = base
        self.input_kind = input_kind

    def bind_column(self, info: ColumnBinding) -> AggFunction:
        if info.kind == "dict":
            return DistinctCountFunction(domain=info.domain, input_kind="codes")
        if info.kind == "rawint":
            return DistinctCountFunction(domain=info.domain, base=info.base, input_kind="values_offset")
        if info.dict_values is not None:
            # misaligned per-segment dictionaries: exact count by unioning
            # DECODED value sets at reduce
            return DistinctCountValueSetFunction(info.dict_values)
        raise NotImplementedError(
            "exact DISTINCTCOUNT needs a dictionary or a bounded int range; "
            "this column has neither (unbounded/float raw values) — use "
            "DISTINCTCOUNTHLL"
        )

    # codes arrive as the "values" argument
    def partial(self, codes, mask):
        return {"present": _presence(mask, codes, self.domain)}

    def partial_grouped(self, codes, mask, keys, num_groups):
        _check_cell_budget(self.name, num_groups, self.domain)
        present = _presence(mask, _flat_cells(keys, self.domain, codes), num_groups * self.domain)
        return {"present": present.reshape(num_groups, self.domain)}

    def merge(self, a, b):
        # the unbound registry singleton merges BOTH partial forms: presence
        # bitmaps (aligned code spaces) and host value sets
        if "valueset" in a:
            return {"valueset": a["valueset"] | b["valueset"]}
        return {"present": np.maximum(a["present"], b["present"])}

    def final(self, p):
        if "valueset" in p:
            return len(p["valueset"])
        return np.asarray(p["present"]).sum(axis=-1)


class DistinctCountValueSetFunction(AggFunction):
    """Exact distinct count across segments with DIFFERENT dictionaries:
    a presence bitmap over the segment's LOCAL dictionary on the device,
    decoded into a frozenset by host_partial; reduce unions the sets.  No
    grouped form (use DISTINCTCOUNTHLL)."""

    name = "distinctcount"
    needs_codes = True
    needs_binding = True
    vector_fields = True
    fields = ("present",)
    input_kind = "codes"

    def __init__(self, dict_values):
        self._values = np.asarray(dict_values, dtype=object)
        self.domain = len(self._values)

    def partial(self, codes, mask):
        return {"present": _presence(mask, codes, self.domain)}

    def partial_grouped(self, codes, mask, keys, num_groups):
        raise NotImplementedError(
            "exact grouped DISTINCTCOUNT requires a shared dictionary across "
            "segments; these segments' dictionaries differ — use DISTINCTCOUNTHLL"
        )

    def host_partial(self, p):
        present = np.asarray(p["present"]) > 0
        return {"valueset": frozenset(self._values[present].tolist())}

    def merge(self, a, b):
        return {"valueset": a["valueset"] | b["valueset"]}

    def final(self, p):
        return len(p["valueset"])


# ---------------------------------------------------------------------------
# DISTINCTCOUNTHLL
# ---------------------------------------------------------------------------
def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over uint64 (host numpy)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _hll_host_tables(values: np.ndarray, log2m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dictionary-id (bucket, rho) from a 64-bit host hash: card hashes
    in all, the device rows only gather.  Numeric dictionaries hash
    vectorized; strings/bytes digest one by one."""
    m = 1 << log2m
    nbits = 64 - log2m
    if values.dtype != object:
        arr = np.asarray(values)
        if arr.dtype.itemsize == 8:
            u = arr.view(np.uint64)
        else:
            u = arr.astype(np.int64).view(np.uint64) if np.issubdtype(arr.dtype, np.integer) else arr.astype(np.float64).view(np.uint64)
        h = _splitmix64_np(u.astype(np.uint64))
        buckets = (h & np.uint64(m - 1)).astype(np.int32)
        w = (h >> np.uint64(log2m)).astype(np.uint64)
        # rho = nbits - floor(log2(w)) for w>0 else nbits+1, via a float64
        # log2 (the JAX package's arithmetic, copied as it is)
        lg = np.zeros(len(w), dtype=np.int32)
        nz = w > 0
        lg[nz] = np.floor(np.log2(w[nz].astype(np.float64))).astype(np.int32)
        rhos = np.where(nz, nbits - lg, nbits + 1).astype(np.int32)
        return buckets, rhos
    import hashlib

    buckets = np.empty(len(values), dtype=np.int32)
    rhos = np.empty(len(values), dtype=np.int32)
    for i, v in enumerate(values):
        b = v if isinstance(v, bytes) else str(v).encode("utf-8")
        h = int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(), "little")
        buckets[i] = h & (m - 1)
        w = h >> log2m
        rhos[i] = (nbits - w.bit_length()) + 1 if w else nbits + 1
    return buckets, rhos


def _device_hash32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on 32-bit lanes held in int64 (values in [0, 2^32))."""
    h = x.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _flush_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals to signed zero, as the JAX package's float64 ->
    float32 conversions give them (XLA runs with denormals flushed on the
    CPU, and the TPU has no float32 subnormals)."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x)


def _bits32(v32: torch.Tensor) -> torch.Tensor:
    """A float32 or int32 tensor's 32-bit pattern as int64 in [0, 2^32)."""
    if v32.dtype == torch.float32:
        v32 = v32.view(torch.int32)
    return v32.to(torch.int64) & _MASK32


def _device_hash_values(v: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash numeric values of any width with 32-bit lane arithmetic; int64
    result in [0, 2^32), equal to the JAX package's uint32 hash.

    8-byte types split into two 32-bit words so (nearly) the full bit
    pattern takes part: LONGs by shift and mask, DOUBLEs as the float32 head
    plus the float32 residual (~48 mantissa bits).  `seed` XORs into the
    input lanes before finalizing, giving an independent stream per seed."""
    seed = int(seed) & _MASK32
    if v.element_size() == 8:
        if v.is_floating_point():
            head = _flush_f32(v.to(torch.float32))
            resid = _flush_f32((v - head.to(torch.float64)).to(torch.float32))
            w0, w1 = _bits32(head), _bits32(resid)
        else:
            w0 = v & _MASK32
            w1 = (v >> 32) & _MASK32
        return _device_hash32((w0 ^ seed) ^ _device_hash32(w1 ^ seed))
    if v.is_floating_point():
        return _device_hash32(_bits32(v.to(torch.float32)) ^ seed)
    return _device_hash32(_bits32(v.to(torch.int32)) ^ seed)


# second-stream seed for the 62-bit KMV hashes
_H2_SEED = 0x9E3779B9


def _device_hash62(values: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 62-bit hash: two independently seeded 32-bit
    streams, h1 -> bits 31..61, h2 -> bits 0..30 (int64 order == unsigned
    order).  Shared by the theta/tuple KMV sketches."""
    h1 = _device_hash_values(values)
    h2 = _device_hash_values(values, seed=_H2_SEED)
    return ((h1 & 0x7FFFFFFF) << 31) | (h2 >> 1)


_INV_LN2_F32 = float(np.float32(1.0 / math.log(2.0)))


def hll_rank(w: torch.Tensor, nbits: int) -> torch.Tensor:
    """HLL register value of the hash's high word w (int64 >= 0): nbits -
    floor(log2 w), or nbits + 1 for w == 0.  floor(log2 w) is the JAX
    package's float32 one, computed as floor(f32(log(f32 w)) * f32(1/ln 2)):
    that equals XLA's float32 log2 for every w < 2^27, including its
    results just below exact powers of two (2^13, 2^15, ...), where an
    integer bit length would differ.  The log runs in float64 and rounds
    once to float32, so the CPU and the card agree."""
    wf = torch.clamp(w, min=1).to(torch.float32)
    lg32 = torch.log(wf.to(torch.float64)).to(torch.float32) * _INV_LN2_F32
    lg = torch.floor(lg32).to(torch.int32)
    return torch.where(w > 0, nbits - lg, torch.full((), nbits + 1, dtype=torch.int32, device=w.device))


class DistinctCountHLLFunction(AggFunction):
    """HyperLogLog distinct count: registers [.., m], combine = max."""

    name = "distinctcounthll"
    needs_codes = True
    needs_binding = True
    vector_fields = True
    fields = ("hll",)
    input_kind = "codes"

    def __init__(self, log2m: int = _DEFAULT_LOG2M, bucket_table=None, rho_table=None, device_hash=False):
        self.log2m = int(log2m)
        self.m = 1 << self.log2m
        self.bucket_table = bucket_table  # np.int32[card] for dict columns
        self.rho_table = rho_table
        self.device_hash = device_hash  # raw path: hash values on device
        self.input_kind = "values_hash" if device_hash else "codes"

    def with_args(self, literal_args):
        if literal_args:
            return DistinctCountHLLFunction(log2m=int(literal_args[0]))
        return self

    def bind_column(self, info: ColumnBinding) -> "DistinctCountHLLFunction":
        if info.dict_values is not None:
            # value-based host hash: registers align across segments even
            # when dictionaries differ (HLL union is value-level)
            b, r = _hll_host_tables(info.dict_values, self.log2m)
            return DistinctCountHLLFunction(self.log2m, bucket_table=b, rho_table=r)
        return DistinctCountHLLFunction(self.log2m, device_hash=True)

    def _bucket_rho(self, values_or_codes: torch.Tensor):
        if self.device_hash:
            h = _device_hash_values(values_or_codes)
            bucket = h & (self.m - 1)
            w = h >> self.log2m
            return bucket, hll_rank(w, 32 - self.log2m)
        dev = values_or_codes.device
        idx = values_or_codes.to(torch.int64)
        return device_constant(self.bucket_table, dev)[idx], device_constant(self.rho_table, dev)[idx]

    def partial(self, codes, mask):
        bucket, rho = self._bucket_rho(codes)
        return {"hll": ops.group_register_max(rho, mask, bucket, self.m)}

    def partial_grouped(self, codes, mask, keys, num_groups):
        _check_cell_budget(self.name, num_groups, self.m)
        bucket, rho = self._bucket_rho(codes)
        regs = ops.group_register_max(rho, mask, _flat_cells(keys, self.m, bucket), num_groups * self.m)
        return {"hll": regs.reshape(num_groups, self.m)}

    def merge(self, a, b):
        return {"hll": np.maximum(a["hll"], b["hll"])}

    def final(self, p):
        regs = np.asarray(p["hll"], dtype=np.float64)
        m = regs.shape[-1]
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / np.sum(np.exp2(-regs), axis=-1)
        zeros = np.sum(regs == 0, axis=-1)
        # small-range correction (linear counting)
        with np.errstate(divide="ignore"):
            lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
        est = np.where((est <= 2.5 * m) & (zeros > 0), lc, est)
        return np.rint(est).astype(np.int64)


# ---------------------------------------------------------------------------
# PERCENTILE (histogram sketch)
# ---------------------------------------------------------------------------
class PercentileFunction(AggFunction):
    """Equi-width histogram percentile: partial = ("hist" add, "lo" min,
    "hi" max).  The engine injects a table-global [lo, hi] via bind_column so
    all segments share bin edges (mergeable by addition)."""

    name = "percentile"
    needs_binding = True
    vector_fields = True
    fields = ("hist", "lo", "hi")

    def __init__(self, rank: float = 50.0, lo: float = 0.0, hi: float = 1.0, bins: int = _DEFAULT_PERCENTILE_BINS):
        self.rank = float(rank)
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)

    def with_args(self, literal_args):
        if literal_args:
            return PercentileFunction(rank=float(literal_args[0]), lo=self.lo, hi=self.hi, bins=self.bins)
        return self

    def bind_column(self, info: ColumnBinding) -> "PercentileFunction":
        lo = float(info.min_value) if info.min_value is not None else 0.0
        hi = float(info.max_value) if info.max_value is not None else 1.0
        if hi <= lo:
            hi = lo + 1.0
        return PercentileFunction(self.rank, lo, hi, self.bins)

    def _bin(self, values: torch.Tensor) -> torch.Tensor:
        # float32 as the JAX package bins: the subtract and the multiply are
        # two rounded operations (eager torch never contracts them)
        v = values.to(torch.float32)
        lo = torch.full((), float(np.float32(self.lo)), dtype=torch.float32, device=v.device)
        scale = float(np.float32(self.bins / (self.hi - self.lo)))
        b = torch.floor((v - lo) * scale).to(torch.int32)
        return torch.clamp(b, 0, self.bins - 1)

    def _range_fields(self, shape, dev):
        lo = torch.full(shape, float(np.float32(self.lo)), dtype=torch.float32, device=dev)
        hi = torch.full(shape, float(np.float32(self.hi)), dtype=torch.float32, device=dev)
        return lo, hi

    def partial(self, values, mask):
        hist = ops.group_count(mask, self._bin(values), self.bins)
        lo, hi = self._range_fields((), mask.device)
        return {"hist": hist, "lo": lo, "hi": hi}

    def partial_grouped(self, values, mask, keys, num_groups):
        _check_cell_budget(self.name, num_groups, self.bins)
        flat = _flat_cells(keys, self.bins, self._bin(values))
        hist = ops.group_count(mask, flat, num_groups * self.bins).reshape(num_groups, self.bins)
        lo, hi = self._range_fields((num_groups,), mask.device)
        return {"hist": hist, "lo": lo, "hi": hi}

    def merge(self, a, b):
        # summing histograms with mismatched edges would silently skew the
        # percentile, so a mismatch is an error, not a merge
        if not (np.allclose(a["lo"], b["lo"]) and np.allclose(a["hi"], b["hi"])):
            raise ValueError(
                "percentile histograms have mismatched bin edges "
                f"([{a['lo']}, {a['hi']}] vs [{b['lo']}, {b['hi']}]) — partials "
                "were built without a shared table-global range"
            )
        return {
            "hist": a["hist"] + b["hist"],
            "lo": np.minimum(a["lo"], b["lo"]),
            "hi": np.maximum(a["hi"], b["hi"]),
        }

    def final(self, p):
        hist = np.atleast_2d(np.asarray(p["hist"], dtype=np.float64))
        lo = np.atleast_1d(np.asarray(p["lo"], dtype=np.float64))
        hi = np.atleast_1d(np.asarray(p["hi"], dtype=np.float64))
        n_groups, bins = hist.shape
        out = np.full(n_groups, np.nan)
        width = (hi - lo) / bins
        for g in range(n_groups):
            total = hist[g].sum()
            if total == 0:
                continue
            target = self.rank / 100.0 * total
            cum = np.cumsum(hist[g])
            idx = int(np.searchsorted(cum, target, side="left"))
            idx = min(idx, bins - 1)
            prev = cum[idx - 1] if idx > 0 else 0.0
            in_bin = hist[g][idx]
            frac = (target - prev) / in_bin if in_bin > 0 else 0.0
            out[g] = lo[g] + width[g] * (idx + frac)
        scalar = np.asarray(p["hist"]).ndim == 1
        return out[0] if scalar else out


# The Est/TDigest names resolve to the same mergeable histogram sketch, as
# in the JAX package (PERCENTILEKLL is aggs_extra.py's log-bucket sketch).
class PercentileEstFunction(PercentileFunction):
    name = "percentileest"


class PercentileTDigestFunction(PercentileFunction):
    name = "percentiletdigest"


for _cls in (
    DistinctCountFunction,
    DistinctCountHLLFunction,
    PercentileFunction,
    PercentileEstFunction,
    PercentileTDigestFunction,
):
    register(_cls())

# Pinot alias: exact distinct count over partitioned segments
_REGISTRY["segmentpartitioneddistinctcount"] = _REGISTRY["distinctcount"]
_REGISTRY["distinctcountbitmap"] = _REGISTRY["distinctcount"]
