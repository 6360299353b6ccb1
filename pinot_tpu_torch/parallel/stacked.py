"""Stacked table: a table's rows as [num_shards, docs_per_shard] column arrays.

Port of pinot_tpu/parallel/stacked.py at one device.  All shards share ONE
dictionary per column, so the key space is global and per-batch dense group
tables add element-wise.  ``docs_per_shard`` is 32-aligned and ``valid``
marks the real rows; the inverted and range indexes cover the flat padded
doc space (num_shards * docs_per_shard rows), so a bitmap word never
straddles a shard and the engine can slice words per macro-batch.

``to_device(device, columns, doc_slice, packed_codes)`` ships the doc slice
[:, lo:hi] of each needed column to the device as a dict of torch tensors
({col: {"codes" | "codes_packed", "dict", "values", "nulls"}}) and caches it
per (backing array, slice, packed).  With a residency manager
(segment/residency.py) each doc slice is a cache group charged to a byte
budget and evicted as a unit, and the copies may go through a caller's
`copy` function (the distributed engine's CUDA copy stream).  Multi-value
columns are a later slice of the port (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.segment import packing
from pinot_tpu_torch.segment import residency as res_mod
from pinot_tpu_torch.segment.dictionary import Dictionary, min_code_dtype
from pinot_tpu_torch.segment.segment import pageable_copy, tensor_source
from pinot_tpu_torch.segment.stats import ColumnStats
from pinot_tpu_torch.spi.schema import DataType, FieldRole, Schema
from pinot_tpu_torch.utils.crashpoints import crash_point

# a host-to-device copy of one host array (segment.tensor_source output)
CopyFn = Callable[[np.ndarray], torch.Tensor]


@dataclass
class StackedColumn:
    """Host-side stacked column: row arrays are [num_shards, docs_per_shard]."""

    name: str
    data_type: DataType
    dictionary: Optional[Dictionary]  # GLOBAL dictionary (shared key space)
    codes: Optional[np.ndarray]  # [S, D] unsigned codes
    values: Optional[np.ndarray]  # [S, D] raw numerics otherwise
    nulls: Optional[np.ndarray]  # [S, D] bool, None if no nulls
    stats: ColumnStats
    # bit-packed forward index: codes in `code_bits` lanes of uint32 words,
    # [S, D * code_bits / 32]; None when the cardinality needs > 16 bits
    code_bits: Optional[int] = None
    packed: Optional[np.ndarray] = None

    @property
    def has_dictionary(self) -> bool:
        return self.dictionary is not None


_BUILD_COUNTER = 0


class StackedTable:
    """A table resident as stacked columns.

    Padding: shards are padded to equal docs_per_shard; `valid[s, d]` marks
    real rows.  The engine masks padded rows in every launch (from the
    static num_docs: padding is always at the tail of the flat doc space)."""

    def __init__(
        self,
        schema: Schema,
        columns: Dict[str, StackedColumn],
        valid: np.ndarray,  # [S, D] bool
        num_docs: int,
        indexes: Optional[Dict[str, Dict[str, Any]]] = None,
    ):
        self.schema = schema
        self.columns = columns
        self.valid = valid
        self.num_docs = num_docs
        self.num_shards, self.docs_per_shard = valid.shape
        # {"inverted"|"range": {column: index}} over the flat padded doc space
        self.indexes: Dict[str, Dict[str, Any]] = indexes or {}
        self._device_cache: Dict[str, Dict[Any, Any]] = {}
        # residency group -> the cache keys it staged (evicted together)
        self._group_keys: Dict[Tuple, Set[Any]] = {}
        # guards both dicts; never held across a device copy
        self._device_lock = threading.Lock()
        # per-instance nonce in signature(): plans bake row-data dependent
        # params (sorted doc ranges, index words), so two tables with equal
        # shapes and dictionaries must never share cached plans
        global _BUILD_COUNTER
        _BUILD_COUNTER += 1
        self._build_nonce = _BUILD_COUNTER

    # -- facade used by FilterCompiler / planner at plan time ------------
    def column(self, name: str) -> StackedColumn:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"stacked table has no column {name!r}") from None

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def signature(self) -> Tuple:
        """Plan cache key component: shapes, dictionary fingerprints and the
        stats-derived limb plans the plans bake in."""
        from pinot_tpu_torch.query.planner import column_limb_sig

        parts: List[Tuple] = [(self.num_shards, self.docs_per_shard, self._build_nonce)]
        for name, c in sorted(self.columns.items()):
            parts.append(
                (
                    name,
                    c.dictionary.fingerprint() if c.dictionary else None,
                    str((c.codes if c.codes is not None else c.values).dtype),
                    c.code_bits,
                    c.nulls is not None,
                    column_limb_sig(c),
                    c.stats.is_sorted,
                    tuple(sorted(k for k, by_col in self.indexes.items() if name in by_col)),
                )
            )
        return tuple(parts)

    # ------------------------------------------------------------------
    @staticmethod
    def build(
        schema: Schema,
        data: Dict[str, np.ndarray],
        num_shards: int,
        no_dictionary_columns: Tuple[str, ...] = (),
        table_config=None,
    ) -> "StackedTable":
        """Build from column-major data, row-partitioned into num_shards.

        table_config.indexing drives the indexes (inverted and range bitmaps
        over the flat padded doc space) and the sorted column (rows sorted
        by it first)."""
        from pinot_tpu_torch.indexes.inverted import InvertedIndex, RangeEncodedIndex
        from pinot_tpu_torch.segment.builder import MAX_BITMAP_INDEX_CARDINALITY, _extract_nulls, narrow_ints
        from pinot_tpu_torch.segment.stats import collect_stats

        idx_cfg = table_config.indexing if table_config is not None else None
        names = schema.column_names
        n = len(data[names[0]]) if names else 0
        # 32-aligned docs_per_shard: bitmap words split cleanly by shard
        D = -(-n // num_shards)
        D = -(-D // 32) * 32
        total = num_shards * D

        if idx_cfg is not None and idx_cfg.sorted_column and idx_cfg.sorted_column in data and n > 1:
            order = np.argsort(np.asarray(data[idx_cfg.sorted_column]), kind="stable")
            if not np.array_equal(order, np.arange(n)):
                data = {k: np.asarray(v)[order] for k, v in data.items()}

        valid = np.zeros(total, dtype=bool)
        valid[:n] = True
        no_dict_cfg = tuple(idx_cfg.no_dictionary_columns) if idx_cfg is not None else ()

        columns: Dict[str, StackedColumn] = {}
        indexes: Dict[str, Dict[str, Any]] = {}
        for f in schema.fields:
            if not f.single_value:
                raise NotImplementedError(
                    f"multi-value column {f.name} in a stacked table is a later slice of the port "
                    "(ROADMAP Queue 1 item 5)"
                )
            arr, nmask = _extract_nulls(f, data[f.name])
            use_dict = f.data_type.is_string_like or (
                f.name not in no_dictionary_columns
                and f.name not in no_dict_cfg
                and f.role in (FieldRole.DIMENSION, FieldRole.DATE_TIME)
            )
            padded_nulls = None
            if nmask is not None:
                padded_nulls = np.zeros(total, dtype=bool)
                padded_nulls[:n] = nmask
                padded_nulls = padded_nulls.reshape(num_shards, D)
            if use_dict:
                dictionary, codes32 = Dictionary.build(f.data_type, arr)
                card = dictionary.cardinality
                codes = np.zeros(total, dtype=min_code_dtype(card))
                codes[:n] = codes32.astype(codes.dtype)
                stats = collect_stats(f.name, f.data_type, arr, nmask, card, True)
                bits = packing.lane_bits(card)
                # D is 32-aligned: no packed word straddles a shard
                packed = packing.pack_codes(codes, bits).reshape(num_shards, -1) if bits < 32 else None
                columns[f.name] = StackedColumn(
                    f.name, f.data_type, dictionary, codes.reshape(num_shards, D), None, padded_nulls, stats,
                    code_bits=bits if bits < 32 else None, packed=packed,
                )
                if idx_cfg is not None and card <= MAX_BITMAP_INDEX_CARDINALITY:
                    # padded rows carry code 0 and enter the bitmaps; every
                    # launch masks them, so they stay invisible
                    if f.name in idx_cfg.inverted_index_columns:
                        indexes.setdefault("inverted", {})[f.name] = InvertedIndex.build(codes, card, total)
                    if f.name in idx_cfg.range_index_columns:
                        indexes.setdefault("range", {})[f.name] = RangeEncodedIndex.build(codes, card, total)
            else:
                card = int(len(np.unique(arr)))
                stats = collect_stats(f.name, f.data_type, arr, nmask, card, False)
                arr = narrow_ints(arr, nmask)
                vals = np.zeros(total, dtype=arr.dtype)
                vals[:n] = arr
                columns[f.name] = StackedColumn(
                    f.name, f.data_type, None, None, vals.reshape(num_shards, D), padded_nulls, stats
                )
        return StackedTable(schema, columns, valid.reshape(num_shards, D), n, indexes=indexes)

    # -- device residency ----------------------------------------------
    @staticmethod
    def _use_packed(c: StackedColumn, sl, packed_codes: bool) -> bool:
        # packed shipping needs lane-aligned doc offsets (the engine's
        # macro-batch offsets are 32-aligned, so this holds there)
        return bool(
            packed_codes
            and c.packed is not None
            and sl[0] % (32 // c.code_bits) == 0
            and sl[1] % (32 // c.code_bits) == 0
        )

    @staticmethod
    def _col_key(c: StackedColumn, sl, use_packed: bool):
        # cache by BACKING-ARRAY identity, not name, as the JAX package does
        arr_id = id(c.codes if c.codes is not None else c.values)
        return (arr_id, sl, "#packed") if use_packed else (arr_id, sl)

    def device_group(self, device: DeviceLike, sl) -> Tuple:
        """Residency cache-group key: ONE doc slice of this table on one
        device.  Slices evict independently (a working set over budget
        rotates through the cache), but all flavours of a slice drop as a
        unit."""
        return ("stacked", id(self), str(resolve_device(device)), sl)

    def _plan_missing(self, dev: torch.device, cols, sl, packed_codes: bool, with_valid: bool):
        """(missing column specs, valid missing?, bytes to charge)."""
        span = sl[1] - sl[0]
        need = []
        nbytes = 0
        need_valid = False
        with self._device_lock:
            cache = self._device_cache.get(str(dev), {})
            for cname in cols:
                c = self.column(cname)
                use_packed = self._use_packed(c, sl, packed_codes)
                ck = self._col_key(c, sl, use_packed)
                if ck in cache:
                    continue
                dkey = cached_dict = None
                if c.codes is not None and c.dictionary is not None:
                    dvals = c.dictionary.device_values()
                    if dvals is not None:
                        dkey = (id(c.dictionary), "dict")
                        cached_dict = cache.get(dkey)
                        if cached_dict is None:
                            nbytes += dvals.nbytes
                        else:
                            dkey = None  # already staged (and charged) once
                if use_packed:
                    f = 32 // c.code_bits
                    nbytes += c.packed[:, sl[0] // f: sl[1] // f].nbytes
                elif c.codes is not None:
                    nbytes += c.codes[:, sl[0]: sl[1]].nbytes
                for arr in (c.values, c.nulls):
                    if arr is not None:
                        nbytes += arr.itemsize * arr.shape[0] * span
                need.append((cname, ck, use_packed, dkey, cached_dict))
            if with_valid:
                vk = (id(self.valid), sl)
                if vk not in cache:
                    need_valid = True
                    nbytes += self.valid[:, sl[0]: sl[1]].nbytes
        return need, need_valid, nbytes

    def _stage_slice(self, need, need_valid: bool, sl, copy: CopyFn) -> Dict[Any, Any]:
        """Host->device copies of one slice's missing entries, each host
        array through `copy` (NO locks held: the staging-stream body)."""

        def rows(a: np.ndarray) -> np.ndarray:
            return tensor_source(a if sl == (0, self.docs_per_shard) else a[:, sl[0]: sl[1]])

        staged: Dict[Any, Any] = {}
        for cname, ck, use_packed, dkey, cached_dict in need:
            c = self.columns[cname]
            entry: Dict[str, torch.Tensor] = {}
            if use_packed:
                f = 32 // c.code_bits
                entry["codes_packed"] = copy(packing.word_view(c.packed[:, sl[0] // f: sl[1] // f]))
            elif c.codes is not None:
                entry["codes"] = copy(rows(c.codes))
            if dkey is not None:
                staged[dkey] = entry["dict"] = copy(tensor_source(c.dictionary.device_values()))
            elif cached_dict is not None:
                entry["dict"] = cached_dict
            if c.values is not None:
                entry["values"] = copy(rows(c.values))
            if c.nulls is not None:
                entry["nulls"] = copy(rows(c.nulls))
            staged[ck] = entry
        if need_valid:
            staged[(id(self.valid), sl)] = copy(rows(self.valid))
        return staged

    def _publish(self, dev: torch.device, group: Tuple, staged: Dict[Any, Any]) -> None:
        """First-wins publish + group-key registration in ONE critical
        section, so eviction drops exactly this group's entries."""
        with self._device_lock:
            cache = self._device_cache.setdefault(str(dev), {})
            for k, v in staged.items():
                cache.setdefault(k, v)
            self._group_keys.setdefault(group, set()).update(staged.keys())

    def _assemble(self, dev: torch.device, cols, sl, packed_codes: bool, with_valid: bool):
        """(cols, valid) read out of the cache in ONE critical section; None
        if a racing eviction removed any needed entry (the caller re-stages
        the whole group, never observing a half-evicted slice)."""
        with self._device_lock:
            cache = self._device_cache.get(str(dev), {})
            out: Dict[str, Dict[str, torch.Tensor]] = {}
            for cname in cols:
                c = self.column(cname)
                ck = self._col_key(c, sl, self._use_packed(c, sl, packed_codes))
                if ck not in cache:
                    return None
                out[cname] = cache[ck]
            if not with_valid:
                # the distributed engine masks padding from num_docs in the
                # launch: the [S, D] bool array never ships
                return out, None
            vk = (id(self.valid), sl)
            if vk not in cache:
                return None
            return out, cache[vk]

    def evict_slice(self, device: DeviceLike, sl) -> None:
        """Atomic flavour invalidation of one slice group: every cache key
        the group staged — raw, #packed, valid, the dictionaries it staged —
        drops in one critical section (the residency eviction callback)."""
        dev = resolve_device(device)
        group = self.device_group(dev, sl)
        with self._device_lock:
            keys = self._group_keys.pop(group, set())
            cache = self._device_cache.get(str(dev), {})
            for k in keys:
                cache.pop(k, None)

    def to_device(
        self,
        device: DeviceLike = None,
        columns: Optional[List[str]] = None,
        doc_slice: Optional[Tuple[int, int]] = None,
        with_valid: bool = True,
        packed_codes: bool = False,
        residency=None,
        prefetch: bool = False,
        query_id: Optional[str] = None,
        copy: Optional[CopyFn] = None,
    ):
        """Ship the doc slice [:, lo:hi] (default: all docs) of `columns` to
        `device` (None: CUDA, raising without it).  Returns (cols, valid):
        cols maps each column to its entry of [S, hi - lo] row tensors (or
        [S, (hi - lo) * bits / 32] lane words under "codes_packed" when
        packed_codes and the slice is lane-aligned); valid is the [S, hi -
        lo] bool tensor, or None when with_valid is False.  Entries are
        cached per device, keyed by the backing array, the slice and the
        packed flavour: the table is immutable.

        With `residency` the device cache is a byte-budgeted tier over the
        host arrays: each doc slice is a cache group that charges the budget
        before copying (evicting cost-ranked victim slices to make room), at
        most one thread stages a group while the rest park on its event,
        and `prefetch=True` marks a stage issued ahead of need (the engine's
        staging stream) for the prefetch-hit accounting.  `copy` makes each
        device tensor from its host array (default: a copy on the current
        stream); it returns before the copy completes when it issues the
        copy on a stream of its own, and the caller orders its launches
        after it."""
        dev = resolve_device(device)
        copy = copy or functools.partial(pageable_copy, device=dev)
        cols = columns or list(self.columns)
        sl = doc_slice if doc_slice is not None else (0, self.docs_per_shard)
        group = self.device_group(dev, sl)

        if residency is None:
            # the plain cache: no budget, no eviction
            while True:
                need, need_valid, _ = self._plan_missing(dev, cols, sl, packed_codes, with_valid)
                if need or need_valid:
                    self._publish(dev, group, self._stage_slice(need, need_valid, sl, copy))
                out = self._assemble(dev, cols, sl, packed_codes, with_valid)
                if out is not None:
                    return out

        while True:
            need, need_valid, _ = self._plan_missing(dev, cols, sl, packed_codes, with_valid)
            st, entry = residency.begin_stage(
                group, self.schema.name, lambda: self.evict_slice(dev, sl), prefetch=prefetch
            )
            if st == res_mod.WAIT:
                residency.wait(entry)
                continue
            if st == res_mod.HIT:
                if not need and not need_valid:
                    out = self._assemble(dev, cols, sl, packed_codes, with_valid)
                    if out is not None:
                        return out
                    continue  # evicted between plan and read: re-stage
                st2, entry2 = residency.begin_grow(group)
                if st2 == res_mod.WAIT:
                    residency.wait(entry2)
                    continue
                if st2 == res_mod.RETRY:
                    continue
            # OWN: charge, copy (no locks held), publish, commit
            try:
                need, need_valid, nbytes = self._plan_missing(dev, cols, sl, packed_codes, with_valid)
                residency.charge(group, nbytes, query_id=query_id)
                crash_point("segment.stage.after_charge")
                staged = self._stage_slice(need, need_valid, sl, copy)
                crash_point("segment.stage.after_copy")
                self._publish(dev, group, staged)
            except BaseException:
                residency.abort_stage(group)
                raise
            residency.finish_stage(group)
            out = self._assemble(dev, cols, sl, packed_codes, with_valid)
            if out is not None:
                return out

    def release_device(self) -> None:
        with self._device_lock:
            self._device_cache.clear()
            self._group_keys.clear()

    # -- host decode -----------------------------------------------------
    def decoded_flat(self, name: str) -> np.ndarray:
        """Row-major decoded values (padding rows included; mask with valid)."""
        c = self.columns[name]
        if c.dictionary is not None:
            return c.dictionary.get_values(c.codes.reshape(-1))
        return c.values.reshape(-1)

    def decoded_rows(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Decoded values of SPECIFIC flat doc ids: O(len(rows)) host work,
        never a full-column decode (a selection reads a LIMIT-sized handful
        of the table's rows)."""
        c = self.columns[name]
        if c.dictionary is not None:
            return c.dictionary.get_values(c.codes.reshape(-1)[rows])
        return c.values.reshape(-1)[rows]
