"""Immutable segment: the unit of storage, distribution and query.

Port of pinot_tpu/segment/segment.py.  Host side: numpy columns with
per-column metadata, dictionaries and indexes (built by segment/builder.py,
or loaded by ``ImmutableSegment.load`` as zero-copy mmaps over the
segment's columns.bin).  ``save`` writes the JAX package's on-disk format
(segment/store.py), so either package loads the other's segments.

Device side: ``to_device(device)`` ships a plain dict of torch tensors —
{col: {"codes" | "codes_packed", "dict", "values", "nulls", "lengths"}} —
and caches it per device, so repeated queries hit resident tensors.
Multi-value columns hold a padded [num_docs, max_len] code matrix (or, for
an embedding column, a [num_docs, max_len] float32 value matrix) with the
per-row element counts under "lengths"; padded cells hold the padding code
(== cardinality), which every predicate treats as no-match.  A star-tree
level's tables are one more entry of the same cache (named by
``star_entry``), so they are charged, evicted and released with the columns.
With a residency manager (segment/residency.py) the cache is byte-budgeted
and evictable.
Static facts (num_docs, cardinalities, stats) stay host-side for pruning
and for the closed-form predicate constants.

Device dtypes: uint8 codes stay uint8; wider codes ship as int32 (torch's
uint16/uint32 support few operators); packed lane words and bitmap words
ship as int32 views of the uint32 words.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.segment import packing, store
from pinot_tpu_torch.segment import residency as res_mod
from pinot_tpu_torch.segment.dictionary import Dictionary, min_code_dtype
from pinot_tpu_torch.segment.stats import ColumnStats, collect_stats
from pinot_tpu_torch.spi.schema import DataType, Schema
from pinot_tpu_torch.utils.crashpoints import crash_point

# Build-time encoding version written into a saved segment's metadata (v2:
# bit-packed forward indexes), as in the JAX package.
BUILDER_VERSION = 2


@dataclass
class ColumnData:
    """One column inside a segment (DataSource analog: forward index +
    dictionary + null vector)."""

    name: str
    data_type: DataType
    dictionary: Optional[Dictionary]  # None => raw storage
    codes: Optional[np.ndarray]  # uint8/16/32[num_docs] (SV) or [num_docs, max_len] (MV)
    values: Optional[np.ndarray]  # raw storage (numeric) when no dictionary
    nulls: Optional[np.ndarray]  # bool[num_docs] true=null, None if no nulls
    stats: ColumnStats
    # multi-value columns: per-row element counts; codes beyond a row's
    # length hold the padding code (== cardinality)
    mv_lengths: Optional[np.ndarray] = None
    # bit-packed forward index (segment/packing.py): codes in `code_bits`
    # lanes of uint32 words; None on raw, MV and wide (>16-bit) columns
    code_bits: Optional[int] = None
    packed: Optional[np.ndarray] = None

    @property
    def has_dictionary(self) -> bool:
        return self.dictionary is not None

    @property
    def is_multi_value(self) -> bool:
        return self.mv_lengths is not None

    @property
    def cardinality(self) -> int:
        return self.dictionary.cardinality if self.dictionary else self.stats.cardinality

    def value_at(self, doc: int):
        """Point read of one value (the upsert merge's reads): no column
        decode.  MV rows read as tuples, a null as None."""
        if self.mv_lengths is not None:
            return tuple(self.decoded_rows(np.asarray([doc]))[0])
        if self.nulls is not None and self.nulls[doc]:
            return None
        if self.dictionary is not None:
            v = self.dictionary.get_values(np.asarray([self.codes[doc]]))[0]
        else:
            v = self.values[doc]
        return v.item() if isinstance(v, np.generic) else v

    def decoded(self) -> np.ndarray:
        """Materialize raw values host-side (tests/golden comparisons).
        MV columns decode to an object array of tuples."""
        if self.mv_lengths is not None:
            return self.decoded_rows(np.arange(len(self.mv_lengths)))
        if self.dictionary is not None:
            return self.dictionary.get_values(self.codes)
        return self.values

    def decoded_rows(self, rows: np.ndarray) -> np.ndarray:
        """decoded()[rows] without decoding the whole column: a selection
        reads a handful of rows of a segment."""
        if self.mv_lengths is not None:
            out = np.empty(len(rows), dtype=object)
            mat = self.codes if self.dictionary is not None else self.values
            for i, r in enumerate(np.asarray(rows)):
                row = mat[r, : int(self.mv_lengths[r])]
                out[i] = tuple(self.dictionary.get_values(row)) if self.dictionary is not None else tuple(row.tolist())
            return out
        if self.dictionary is not None:
            return self.dictionary.get_values(self.codes[rows])
        return self.values[rows]


# device-cache name prefix of a star-tree level's entry
_STAR_ENTRY = "#startree/"


def star_entry(tree: str, k: int) -> str:
    """The device-cache name of level k of the segment's star-tree `tree`:
    ``to_device(columns=[star_entry(tree, k)])`` stages the level's tables
    (indexes/startree.py StarLevel.host_arrays) as one entry."""
    return f"{_STAR_ENTRY}{tree}/{k}"


def tensor_source(arr: np.ndarray) -> np.ndarray:
    """The host array a device tensor of `arr` is made from: C-contiguous,
    uint16/uint32 codes widened to int32 (codes only: < 2^31; torch's
    unsigned types support few operators)."""
    a = np.ascontiguousarray(arr)
    if a.dtype in (np.uint16, np.uint32):
        a = a.astype(np.int32)
    return a


def pageable_copy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array to `device` on the current stream (a read-only mmap is
    copied into writable memory first)."""
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return pageable_copy(tensor_source(arr), device)


class ImmutableSegment:
    """Loaded immutable segment with per-device tensor residency."""

    def __init__(
        self,
        name: str,
        table_name: str,
        schema: Schema,
        columns: Dict[str, ColumnData],
        num_docs: int,
        indexes: Optional[Dict[str, Dict[str, Any]]] = None,
        creation_time_ms: int = 0,
        time_range: Optional[tuple] = None,
    ):
        self.name = name
        self.table_name = table_name
        self.schema = schema
        self.columns = columns
        self.num_docs = num_docs
        # indexes[kind][column] -> index object (indexes/ package)
        self.indexes: Dict[str, Dict[str, Any]] = indexes or {}
        self.creation_time_ms = creation_time_ms
        self.time_range = time_range  # (min, max) of the table's time column
        # upsert validDocIds (realtime/upsert.py): a bool mask the planner
        # ANDs into every filter as a per-query param.  A sealed segment's
        # mask is shared with the upsert manager, which clears rows in
        # place: it is never staged into the device cache.
        self.valid_docs: Optional[np.ndarray] = None
        # new doc position -> input row, when the build sorted the rows
        # (the upsert manager remaps its doc ids through it at seal)
        self.sort_order: Optional[np.ndarray] = None
        # a consuming segment's snapshot: not on disk
        self.in_memory = False
        self._device_cache: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
        # guards _device_cache reads and publishes under tiered residency;
        # NEVER held across a device copy: owners stage with no lock held,
        # then publish in one critical section, so a query racing an
        # eviction re-checks instead of mixing tiers
        self._device_lock = threading.Lock()
        # durable home of this segment on local disk (set by save/load)
        self.source_dir: Optional[str] = None

    def column(self, name: str) -> ColumnData:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"segment {self.name} has no column {name!r}") from None

    def _source(self, cname: str):
        """What one device-cache entry is staged from: a column, or for a
        ``star_entry`` name the star-tree level's host arrays."""
        if cname.startswith(_STAR_ENTRY):
            tree, k = cname[len(_STAR_ENTRY):].rsplit("/", 1)
            return self.indexes["startree"][tree].levels[int(k)].host_arrays(self)
        return self.column(cname)

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def ensure_columns(self, table_schema: Schema, names) -> None:
        """Schema evolution: synthesize virtual columns for fields the TABLE
        schema has but this (older) segment lacks.  Old rows read as SQL
        NULL (null mask all-set over the type placeholder), as in the JAX
        package — a documented delta from Pinot's defaultColumnHandler,
        whose legacy semantics return the default VALUE."""
        for name in names:
            if name in self.columns or name not in table_schema:
                continue
            f = table_schema.field(name)
            if not f.single_value:
                raise NotImplementedError(f"virtual default for MV column {name} is unsupported")
            default = f.data_type.null_placeholder
            n = self.num_docs
            nulls = np.ones(n, dtype=bool)
            if f.data_type.is_string_like:
                dictionary, _ = Dictionary.build(f.data_type, np.asarray([default], dtype=object))
                codes = np.zeros(n, dtype=np.uint8)
                stats = collect_stats(name, f.data_type, np.asarray([default], dtype=object), None, 1, True)
                stats.num_docs = n
                self.columns[name] = ColumnData(name, f.data_type, dictionary, codes, None, nulls, stats)
            else:
                arr = np.broadcast_to(f.data_type.np_dtype.type(default), (n,))
                stats = collect_stats(name, f.data_type, np.asarray([default]), None, 1, False)
                stats.num_docs = n
                self.columns[name] = ColumnData(name, f.data_type, None, None, arr, nulls, stats)

    # -- device residency ----------------------------------------------
    def device_group(self, device: DeviceLike = None) -> Tuple:
        """Residency cache-group key: ALL flavours (raw and #packed) of this
        segment on one device live and die as a unit."""
        return ("seg", id(self), str(resolve_device(device)))

    @staticmethod
    def _entry_bytes(c, use_packed: bool) -> int:
        """Host-side estimate of the device bytes one cache entry pins."""
        if isinstance(c, dict):  # a star-tree level
            return sum(a.nbytes for a in c.values())
        n = 0
        if use_packed:
            n += c.packed.nbytes
        elif c.codes is not None:
            n += c.codes.nbytes
        if c.codes is not None and c.dictionary is not None:
            dvals = c.dictionary.device_values()
            if dvals is not None:
                n += dvals.nbytes
        for arr in (c.values, c.nulls, c.mv_lengths):
            if arr is not None:
                n += arr.nbytes
        return n

    @staticmethod
    def _key(cname: str, c, packed_codes: bool) -> Tuple[str, bool]:
        use_packed = bool(packed_codes and isinstance(c, ColumnData) and c.packed is not None)
        return (f"{cname}#packed" if use_packed else cname), use_packed

    def _plan_missing(self, dev: torch.device, cols, packed_codes):
        """(missing [(cname, key, use_packed)], bytes) the cache lacks."""
        need = []
        nbytes = 0
        with self._device_lock:
            cache = self._device_cache.get(str(dev), {})
            for cname in cols:
                c = self._source(cname)
                key, use_packed = self._key(cname, c, packed_codes)
                if key in cache:
                    continue
                need.append((cname, key, use_packed))
                nbytes += self._entry_bytes(c, use_packed)
        return need, nbytes

    @staticmethod
    def _stage_entry(c, use_packed: bool, device: torch.device) -> Dict[Any, torch.Tensor]:
        """One column's (or star-tree level's) host->device copy (no lock
        held)."""
        if isinstance(c, dict):
            return {key: _to_tensor(a, device) for key, a in c.items()}
        entry: Dict[str, torch.Tensor] = {}
        if use_packed:
            entry["codes_packed"] = packing.words_to_torch(c.packed, device)
        elif c.codes is not None:
            entry["codes"] = _to_tensor(c.codes, device)
        if c.codes is not None and c.dictionary is not None:
            dvals = c.dictionary.device_values()
            if dvals is not None:
                entry["dict"] = _to_tensor(dvals, device)
        if c.values is not None:
            entry["values"] = _to_tensor(c.values, device)
        if c.nulls is not None:
            entry["nulls"] = _to_tensor(c.nulls.astype(bool), device)
        if c.mv_lengths is not None:
            entry["lengths"] = _to_tensor(c.mv_lengths, device)
        return entry

    def _assemble(self, dev: torch.device, cols, packed_codes) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """Read the entries out of the cache in ONE critical section; None if
        any needed entry vanished (a racing eviction): the caller re-stages
        the whole group, so it never observes a half-evicted segment."""
        with self._device_lock:
            cache = self._device_cache.get(str(dev), {})
            out: Dict[str, Dict[str, torch.Tensor]] = {}
            for cname in cols:
                key, _ = self._key(cname, self._source(cname), packed_codes)
                if key not in cache:
                    return None
                out[cname] = cache[key]
            return out

    def evict_device(self, device: DeviceLike = None) -> None:
        """Atomic flavour invalidation: the entire per-device cache region —
        raw, #packed, dict and null entries together — drops in one critical
        section (the residency eviction callback)."""
        with self._device_lock:
            self._device_cache.pop(str(resolve_device(device)), None)

    def to_device(
        self,
        device: DeviceLike = None,
        columns: Optional[List[str]] = None,
        packed_codes: bool = False,
        residency=None,
        prefetch: bool = False,
        query_id: Optional[str] = None,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Ship column arrays to `device` (None: CUDA, raising without it);
        returns {column: entry}.  Entries are cached per device — segments
        are immutable.  packed_codes=True ships bit-packed columns as int32
        lane words under "codes_packed" instead of widened "codes"; the two
        shapes cache under distinct keys.

        With `residency` (segment/residency.py) the cache is a byte-budgeted
        tier over the host arrays: staging charges the budget (evicting
        cost-ranked victims to make room), at most one thread copies while
        the rest park on the group's event, and a mid-stage failure unwinds
        the charge.  `prefetch=True` marks a stage issued ahead of need for
        the prefetch-hit accounting.  Without `residency` this is the plain
        pin-everything cache."""
        dev = resolve_device(device)
        cols = columns or list(self.columns)
        if residency is None:
            out: Dict[str, Dict[str, torch.Tensor]] = {}
            for cname in cols:
                c = self._source(cname)
                key, use_packed = self._key(cname, c, packed_codes)
                with self._device_lock:
                    entry = self._device_cache.setdefault(str(dev), {}).get(key)
                if entry is None:
                    entry = self._stage_entry(c, use_packed, dev)
                    with self._device_lock:
                        entry = self._device_cache.setdefault(str(dev), {}).setdefault(key, entry)
                out[cname] = entry
            return out

        group = self.device_group(dev)
        while True:
            missing, _ = self._plan_missing(dev, cols, packed_codes)
            st, entry = residency.begin_stage(
                group, self.table_name, lambda: self.evict_device(dev), prefetch=prefetch
            )
            if st == res_mod.WAIT:
                residency.wait(entry)
                continue
            if st == res_mod.HIT:
                if not missing:
                    out = self._assemble(dev, cols, packed_codes)
                    if out is not None:
                        return out
                    continue  # evicted between plan and read: re-stage
                # resident but lacking columns/flavours this query needs:
                # claim the group for incremental staging
                st2, entry2 = residency.begin_grow(group)
                if st2 == res_mod.WAIT:
                    residency.wait(entry2)
                    continue
                if st2 == res_mod.RETRY:
                    continue
            # OWN: charge, copy (no locks held), publish, commit
            try:
                missing, nbytes = self._plan_missing(dev, cols, packed_codes)
                residency.charge(group, nbytes, query_id=query_id)
                crash_point("segment.stage.after_charge")
                staged = {key: self._stage_entry(self._source(cname), up, dev) for cname, key, up in missing}
                crash_point("segment.stage.after_copy")
                with self._device_lock:
                    self._device_cache.setdefault(str(dev), {}).update(staged)
            except BaseException:
                residency.abort_stage(group)
                raise
            residency.finish_stage(group)
            out = self._assemble(dev, cols, packed_codes)
            if out is not None:
                return out

    def release_device(self) -> None:
        with self._device_lock:
            self._device_cache.clear()

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """Write the segment to directory `path` in the JAX package's format
        (segment/store.py): packed columns persist their lane words, null
        masks as packed bits, indexes as their own regions."""
        regions = []
        col_meta = []
        for c in self.columns.values():
            if c.dictionary is not None:
                regions.extend(c.dictionary.to_regions(c.name))
                regions.append((f"{c.name}.fwd", c.packed if c.packed is not None else c.codes))
            else:
                regions.append((f"{c.name}.fwd", c.values))
            if c.nulls is not None:
                regions.append((f"{c.name}.nulls", np.packbits(c.nulls)))
            if c.mv_lengths is not None:
                regions.append((f"{c.name}.mvlen", c.mv_lengths))
            cm = {"stats": c.stats.to_dict(), "hasNulls": c.nulls is not None, "isMV": c.mv_lengths is not None}
            if c.packed is not None:
                cm["codeBits"] = int(c.code_bits)
            col_meta.append(cm)
        for kind, by_col in self.indexes.items():
            for cname, idx in by_col.items():
                regions.extend(idx.to_regions(f"{cname}.{kind}"))
        meta = {
            "segmentName": self.name,
            "tableName": self.table_name,
            "numDocs": self.num_docs,
            "builderVersion": BUILDER_VERSION,
            "schema": self.schema.to_dict(),
            "columns": col_meta,
            "indexes": {kind: {c: idx.meta() for c, idx in by_col.items()} for kind, by_col in self.indexes.items()},
            "creationTimeMs": self.creation_time_ms,
            "timeRange": [v.item() if isinstance(v, np.generic) else v for v in self.time_range]
            if self.time_range
            else None,
        }
        store.write_segment(path, meta, regions)
        self.source_dir = path

    @staticmethod
    def load(path: str, verify: bool = False) -> "ImmutableSegment":
        """mmap-load (ImmutableSegmentLoader.load analog, ReadMode.mmap).

        verify=True checks columns.bin against the committed size and CRC32
        first (SegmentCorruptError on a mismatch).  Packed columns
        rematerialize their codes host-side; every other region stays a
        zero-copy mmap."""
        from pinot_tpu_torch.indexes import load_index  # local import; avoids a cycle

        meta, regions = store.read_segment(path, verify=verify)
        schema = Schema.from_dict(meta["schema"])
        num_docs = meta["numDocs"]
        columns: Dict[str, ColumnData] = {}
        for cm in meta["columns"]:
            stats = ColumnStats.from_dict(cm["stats"])
            name = stats.name
            dt = stats.data_type
            mv_lengths = regions[f"{name}.mvlen"] if cm.get("isMV") else None
            nulls = None
            if cm.get("hasNulls"):
                nulls = np.unpackbits(np.asarray(regions[f"{name}.nulls"]), count=num_docs).astype(bool)
            fwd = regions[f"{name}.fwd"]
            if stats.has_dictionary:
                dictionary = Dictionary.from_regions(dt, regions, name)
                bits = cm.get("codeBits")  # absent on pre-v2 segments: raw codes
                packed = None
                codes = fwd
                if bits and bits < 32:
                    packed = np.asarray(fwd)
                    codes = packing.unpack_codes(packed, bits, num_docs, dtype=min_code_dtype(dictionary.cardinality))
                columns[name] = ColumnData(
                    name, dt, dictionary, codes, None, nulls, stats,
                    mv_lengths=mv_lengths, code_bits=bits, packed=packed,
                )
            else:
                columns[name] = ColumnData(name, dt, None, None, fwd, nulls, stats, mv_lengths=mv_lengths)
        indexes: Dict[str, Dict[str, Any]] = {}
        for kind, by_col in meta.get("indexes", {}).items():
            for cname, idx_meta in by_col.items():
                indexes.setdefault(kind, {})[cname] = load_index(kind, idx_meta, regions, f"{cname}.{kind}")
        # text indexes evaluate phrase queries over the ORIGINAL values:
        # rehydrate them from the column dictionary (not persisted twice)
        for cname, idx in indexes.get("text", {}).items():
            if cname in columns and columns[cname].dictionary is not None:
                idx.values = columns[cname].dictionary.values
        seg = ImmutableSegment(
            name=meta["segmentName"],
            table_name=meta["tableName"],
            schema=schema,
            columns=columns,
            num_docs=num_docs,
            indexes=indexes,
            creation_time_ms=meta.get("creationTimeMs", 0),
            time_range=tuple(meta["timeRange"]) if meta.get("timeRange") else None,
        )
        seg.source_dir = path
        return seg
