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
per (backing array, slice, packed) — one plain cache, no budget.  Residency
tiering and prefetch (segment/residency.py) and multi-value columns are
later slices of the port (ROADMAP Queue 1 items 3 and 5).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.segment import packing
from pinot_tpu_torch.segment.dictionary import Dictionary, min_code_dtype
from pinot_tpu_torch.segment.segment import _to_tensor
from pinot_tpu_torch.segment.stats import ColumnStats
from pinot_tpu_torch.spi.schema import DataType, FieldRole, Schema


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

    def _stage_column(self, c: StackedColumn, sl, use_packed: bool, dicts, device) -> Dict[str, torch.Tensor]:
        """One column's doc slice [:, lo:hi], host -> device."""

        def rows(a: np.ndarray) -> np.ndarray:
            return a if sl == (0, self.docs_per_shard) else np.ascontiguousarray(a[:, sl[0]:sl[1]])

        entry: Dict[str, torch.Tensor] = {}
        if use_packed:
            f = 32 // c.code_bits
            entry["codes_packed"] = packing.words_to_torch(c.packed[:, sl[0] // f: sl[1] // f], device)
        elif c.codes is not None:
            entry["codes"] = _to_tensor(rows(c.codes), device)
        if c.dictionary is not None:
            dvals = c.dictionary.device_values()
            if dvals is not None:
                dkey = (id(c.dictionary), "dict")
                if dkey not in dicts:
                    dicts[dkey] = _to_tensor(dvals, device)
                entry["dict"] = dicts[dkey]
        if c.values is not None:
            entry["values"] = _to_tensor(rows(c.values), device)
        if c.nulls is not None:
            entry["nulls"] = _to_tensor(rows(c.nulls), device)
        return entry

    def to_device(
        self,
        device: DeviceLike = None,
        columns: Optional[List[str]] = None,
        doc_slice: Optional[Tuple[int, int]] = None,
        with_valid: bool = True,
        packed_codes: bool = False,
        residency=None,
        prefetch: bool = False,
    ):
        """Ship the doc slice [:, lo:hi] (default: all docs) of `columns` to
        `device` (None: CUDA, raising without it).  Returns (cols, valid):
        cols maps each column to its entry of [S, hi - lo] row tensors (or
        [S, (hi - lo) * bits / 32] lane words under "codes_packed" when
        packed_codes and the slice is lane-aligned); valid is the [S, hi -
        lo] bool tensor, or None when with_valid is False.  Entries are
        cached per device, keyed by the backing array, the slice and the
        packed flavour: the table is immutable."""
        if residency is not None or prefetch:
            raise NotImplementedError(
                "residency tiering and prefetch are a later slice of the port (ROADMAP Queue 1 item 3)"
            )
        dev = resolve_device(device)
        cols = columns or list(self.columns)
        sl = doc_slice if doc_slice is not None else (0, self.docs_per_shard)
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        with self._device_lock:
            cache = self._device_cache.setdefault(str(dev), {})
            for cname in cols:
                c = self.column(cname)
                use_packed = self._use_packed(c, sl, packed_codes)
                arr_id = id(c.codes if c.codes is not None else c.values)
                key = (arr_id, sl, "#packed") if use_packed else (arr_id, sl)
                if key not in cache:
                    cache[key] = self._stage_column(c, sl, use_packed, cache, dev)
                out[cname] = cache[key]
            valid = None
            if with_valid:
                vk = (id(self.valid), sl)
                if vk not in cache:
                    cache[vk] = _to_tensor(self.valid[:, sl[0]:sl[1]], dev)
                valid = cache[vk]
        return out, valid

    def release_device(self) -> None:
        with self._device_lock:
            self._device_cache.clear()

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
