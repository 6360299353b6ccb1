"""Segment builder: column data -> immutable columnar segment.

Trimmed copy of pinot_tpu/segment/builder.py: null extraction, the sorted
column, dictionaries, bit-packed forward indexes, column stats, the
inverted, range and bloom indexes, the time range of the table's time
column, and `output_dir=` (the segment is saved there as it is built).
JSON/text/vector/star-tree indexes and partition metadata come with later
slices (the port's TableConfig has no field for them yet); a schema with
multi-value columns raises NotImplementedError here rather than building a
segment that silently differs from the JAX package's.

Encoding policy (as in the JAX package):
  * STRING/BYTES/JSON: always dictionary-encoded — the device sees codes only.
  * Numeric DIMENSION / DATE_TIME: dictionary-encoded unless listed in
    no_dictionary_columns.
  * METRIC: raw storage by default.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from pinot_tpu_torch.indexes.bloom import BloomFilter
from pinot_tpu_torch.indexes.inverted import CompressedInvertedIndex, InvertedIndex, RangeEncodedIndex
from pinot_tpu_torch.segment import packing
from pinot_tpu_torch.segment.dictionary import Dictionary, min_code_dtype
from pinot_tpu_torch.segment.segment import ColumnData, ImmutableSegment
from pinot_tpu_torch.segment.stats import collect_stats
from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
from pinot_tpu_torch.spi.schema import FieldRole, Schema

# Above this cardinality, dense bitmap indexes give way to posting lists.
MAX_BITMAP_INDEX_CARDINALITY = 1 << 16

ColumnInput = Union[np.ndarray, Sequence[Any]]


def _extract_nulls(field, raw: ColumnInput) -> (np.ndarray, Optional[np.ndarray]):
    """Split out a null mask and substitute typed placeholders."""
    dt = field.data_type
    arr = np.asarray(raw, dtype=object) if not isinstance(raw, np.ndarray) or raw.dtype == object else raw
    null_mask = None
    if arr.dtype == object:
        null_mask = np.array([v is None or (isinstance(v, float) and np.isnan(v)) for v in arr], dtype=bool)
        if null_mask.any():
            arr = arr.copy()
            arr[null_mask] = dt.null_placeholder
        else:
            null_mask = None
        if not dt.is_string_like:
            arr = arr.astype(dt.np_dtype)
    else:
        if np.issubdtype(arr.dtype, np.floating):
            nan = np.isnan(arr)
            if nan.any():
                null_mask = nan
                arr = np.where(nan, dt.np_dtype.type(dt.null_placeholder), arr)
        if not dt.is_string_like:
            arr = arr.astype(dt.np_dtype, copy=False)
    if dt.is_string_like and arr.dtype != object:
        arr = arr.astype(object)
    if null_mask is not None and not field.nullable:
        raise ValueError(f"nulls in non-nullable column {field.name}")
    return arr, null_mask


def narrow_ints(arr: np.ndarray, nmask: Optional[np.ndarray]) -> np.ndarray:
    """Store 64-bit integer columns as int32 when the value range fits (the
    JAX package's storage rule, kept so both packages hold the same arrays;
    it also halves the bytes a scan reads).  Columns with nulls keep their
    dtype (the null placeholder is int64-min)."""
    if (
        nmask is None
        and np.issubdtype(arr.dtype, np.integer)
        and arr.dtype.itemsize > 4
        and len(arr)
        and np.iinfo(np.int32).min <= arr.min()
        and arr.max() <= np.iinfo(np.int32).max
    ):
        return arr.astype(np.int32)
    return arr


def _refuse_unported(schema: Schema) -> None:
    mv = [f.name for f in schema.fields if not f.single_value]
    if mv:
        raise NotImplementedError(f"multi-value columns {mv} are not ported yet (later slice of the port)")


def build_segment(
    schema: Schema,
    data: Dict[str, ColumnInput],
    segment_name: str,
    table_config: Optional[TableConfig] = None,
    output_dir: Optional[str] = None,
) -> ImmutableSegment:
    """Build an immutable segment from column-major data; with output_dir,
    also save it there, as Pinot saves a segment when its build ends."""
    cfg = table_config or TableConfig(name=schema.name)
    _refuse_unported(schema)
    idx_cfg: IndexingConfig = cfg.indexing
    names = schema.column_names
    missing = [n for n in names if n not in data]
    if missing:
        raise ValueError(f"missing columns in input data: {missing}")
    lengths = {n: len(data[n]) for n in names}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"ragged column lengths: {lengths}")
    num_docs = lengths[names[0]] if names else 0

    arrays: Dict[str, np.ndarray] = {}
    nulls: Dict[str, Optional[np.ndarray]] = {}
    for f in schema.fields:
        arrays[f.name], nulls[f.name] = _extract_nulls(f, data[f.name])

    # Sort by the configured sorted column (contiguous docId ranges for
    # predicates on that column).
    if idx_cfg.sorted_column and idx_cfg.sorted_column in arrays and num_docs > 1:
        order = np.argsort(arrays[idx_cfg.sorted_column], kind="stable")
        if not np.array_equal(order, np.arange(num_docs)):
            for n in names:
                arrays[n] = np.asarray(arrays[n])[order]
                if nulls[n] is not None:
                    nulls[n] = nulls[n][order]

    columns: Dict[str, ColumnData] = {}
    indexes: Dict[str, Dict[str, Any]] = {}
    for f in schema.fields:
        arr, nmask = arrays[f.name], nulls[f.name]
        if _wants_dictionary(f, idx_cfg):
            dictionary, codes32 = Dictionary.build(f.data_type, arr)
            codes = codes32.astype(min_code_dtype(dictionary.cardinality))
            stats = collect_stats(f.name, f.data_type, arr, nmask, dictionary.cardinality, True)
            bits = packing.lane_bits(dictionary.cardinality)
            columns[f.name] = ColumnData(
                f.name, f.data_type, dictionary, codes, None, nmask, stats,
                code_bits=bits if bits < 32 else None,
                packed=packing.pack_codes(codes, bits) if bits < 32 else None,
            )
            card = dictionary.cardinality
            if f.name in idx_cfg.inverted_index_columns:
                if card <= MAX_BITMAP_INDEX_CARDINALITY:
                    indexes.setdefault("inverted", {})[f.name] = InvertedIndex.build(codes32, card, num_docs)
                else:
                    indexes.setdefault("inverted", {})[f.name] = CompressedInvertedIndex.build(
                        codes32, card, num_docs
                    )
            if f.name in idx_cfg.range_index_columns and card <= MAX_BITMAP_INDEX_CARDINALITY:
                indexes.setdefault("range", {})[f.name] = RangeEncodedIndex.build(codes32, card, num_docs)
        else:
            if f.data_type.is_string_like:
                raise ValueError(f"string column {f.name} requires a dictionary")
            card = int(len(np.unique(arr)))
            stats = collect_stats(f.name, f.data_type, arr, nmask, card, False)
            columns[f.name] = ColumnData(f.name, f.data_type, None, None, narrow_ints(arr, nmask), nmask, stats)
        if f.name in idx_cfg.bloom_filter_columns:
            c = columns[f.name]
            uniq = c.dictionary.values if c.dictionary is not None else np.unique(arr)
            indexes.setdefault("bloom", {})[f.name] = BloomFilter.build(list(uniq))

    time_range = None
    tc = cfg.segments.time_column
    if tc and tc in columns:
        s = columns[tc].stats
        time_range = (s.min_value, s.max_value)

    seg = ImmutableSegment(
        name=segment_name,
        table_name=cfg.name,
        schema=schema,
        columns=columns,
        num_docs=num_docs,
        indexes=indexes,
        creation_time_ms=int(time.time() * 1000),
        time_range=time_range,
    )
    if output_dir is not None:
        seg.save(output_dir)
    return seg


def _wants_dictionary(f, idx_cfg: IndexingConfig) -> bool:
    if f.data_type.is_string_like:
        return True
    if f.name in idx_cfg.no_dictionary_columns:
        return False
    return f.role in (FieldRole.DIMENSION, FieldRole.DATE_TIME)
