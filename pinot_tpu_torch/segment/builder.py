"""Segment builder: column data -> immutable columnar segment.

Copy of pinot_tpu/segment/builder.py: null extraction, the sorted column,
dictionaries, bit-packed forward indexes, column stats, the inverted,
range, bloom, JSON and text indexes, multi-value columns (a padded
[num_docs, max_len] code matrix with per-row lengths), embedding columns
with their vector index, the star-tree levels, the time range of the
table's time column, and `output_dir=` (the segment is saved there as it
is built).  Partition metadata comes with the cluster slice.

A multi-value column's input is a sequence of per-row sequences (None is
an empty row), as in the JAX package, or a ``RaggedColumn`` of flat values
and per-row lengths, which builds the same column without a Python loop
over the rows.  The star-tree levels are built with torch on the host
(indexes/startree.py); every other step is host numpy.

Encoding policy (as in the JAX package):
  * STRING/BYTES/JSON: always dictionary-encoded — the device sees codes only.
  * Numeric DIMENSION / DATE_TIME: dictionary-encoded unless listed in
    no_dictionary_columns.
  * METRIC: raw storage by default.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from pinot_tpu_torch.indexes.bloom import BloomFilter
from pinot_tpu_torch.indexes.inverted import CompressedInvertedIndex, InvertedIndex, RangeEncodedIndex
from pinot_tpu_torch.indexes.jsonidx import JsonIndex
from pinot_tpu_torch.indexes.startree import StarTreeIndex
from pinot_tpu_torch.indexes.text import TextIndex
from pinot_tpu_torch.indexes.vector import VectorIndex
from pinot_tpu_torch.segment import packing
from pinot_tpu_torch.segment.dictionary import Dictionary, min_code_dtype
from pinot_tpu_torch.segment.segment import ColumnData, ImmutableSegment
from pinot_tpu_torch.segment.stats import collect_stats
from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
from pinot_tpu_torch.spi.schema import FieldRole, Schema

# Above this cardinality, dense bitmap indexes give way to posting lists.
MAX_BITMAP_INDEX_CARDINALITY = 1 << 16



@dataclass
class RaggedColumn:
    """A multi-value column as flat element values (row-major) and per-row
    element counts: row i holds values[offsets[i]:offsets[i] + lengths[i]]."""

    values: np.ndarray
    lengths: np.ndarray

    def __len__(self) -> int:
        return len(self.lengths)

    @staticmethod
    def from_rows(rows: Sequence[Any], data_type) -> "RaggedColumn":
        """Per-row sequences (None = empty row) -> flat values + lengths."""
        rows = [() if r is None else r for r in rows]
        lengths = np.fromiter(map(len, rows), dtype=np.int32, count=len(rows))
        flat = list(itertools.chain.from_iterable(rows))
        values = np.fromiter(flat, dtype=object, count=len(flat))  # the objects as they are
        if not data_type.is_string_like:
            values = values.astype(data_type.np_dtype)
        return RaggedColumn(values, lengths)

    def take(self, order: np.ndarray) -> "RaggedColumn":
        """The rows in `order` (the sorted-column reorder)."""
        lengths = np.asarray(self.lengths)[order]
        starts = np.concatenate([[0], np.cumsum(self.lengths, dtype=np.int64)])[:-1][order]
        new_starts = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])[:-1]
        src = np.repeat(starts - new_starts, lengths) + np.arange(int(lengths.sum()), dtype=np.int64)
        return RaggedColumn(np.asarray(self.values)[src], lengths)

    def padded(self, fill, dtype) -> np.ndarray:
        """[rows, max(1, max length)] matrix of the rows, `fill` past each
        row's length."""
        n = len(self.lengths)
        max_len = max(1, int(self.lengths.max()) if n else 1)
        if n and int(self.lengths.min()) == max_len:  # no padding: a reshape (embedding rows)
            return np.asarray(self.values, dtype=dtype).reshape(n, max_len)
        mat = np.full((n, max_len), fill, dtype=dtype)
        rows = np.repeat(np.arange(n), self.lengths)
        starts = np.concatenate([[0], np.cumsum(self.lengths, dtype=np.int64)])[:-1]
        cols = np.arange(len(rows), dtype=np.int64) - np.repeat(starts, self.lengths)
        mat[rows, cols] = self.values
        return mat


ColumnInput = Union[np.ndarray, Sequence[Any], RaggedColumn]


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
        if not f.single_value:
            # multi-value fields build through the MV path below (a null row
            # is an empty row, the reference's default MV null handling)
            raw = data[f.name]
            arrays[f.name] = raw if isinstance(raw, RaggedColumn) else RaggedColumn.from_rows(raw, f.data_type)
            nulls[f.name] = None
            continue
        arrays[f.name], nulls[f.name] = _extract_nulls(f, data[f.name])

    # Sort by the configured sorted column (contiguous docId ranges for
    # predicates on that column).
    sort_order = None  # new position -> input row (the upsert remap at seal)
    if idx_cfg.sorted_column and idx_cfg.sorted_column in arrays and num_docs > 1:
        order = np.argsort(arrays[idx_cfg.sorted_column], kind="stable")
        if not np.array_equal(order, np.arange(num_docs)):
            sort_order = order
            for n in names:
                a = arrays[n]
                arrays[n] = a.take(order) if isinstance(a, RaggedColumn) else np.asarray(a)[order]
                if nulls[n] is not None:
                    nulls[n] = nulls[n][order]

    columns: Dict[str, ColumnData] = {}
    indexes: Dict[str, Dict[str, Any]] = {}
    for f in schema.fields:
        arr, nmask = arrays[f.name], nulls[f.name]
        if not f.single_value:
            if f.name in idx_cfg.vector_index_columns:
                columns[f.name], indexes.setdefault("vector", {})[f.name] = _build_vector_column(f, arr, num_docs)
            else:
                columns[f.name] = _build_mv_column(f, arr, num_docs)
            continue
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
            if f.name in idx_cfg.json_index_columns:
                indexes.setdefault("json", {})[f.name] = JsonIndex.build(dictionary.values)
            if f.name in idx_cfg.text_index_columns:
                indexes.setdefault("text", {})[f.name] = TextIndex.build(dictionary.values)
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

    trees = build_star_trees(columns, num_docs, idx_cfg.star_tree_index_configs)
    if trees:
        indexes["startree"] = trees

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
    seg.sort_order = sort_order
    if output_dir is not None:
        seg.save(output_dir)
    return seg


def build_star_trees(
    columns: Dict[str, ColumnData], num_docs: int, configs: List[Dict[str, Any]]
) -> Dict[str, StarTreeIndex]:
    """The star-tree indexes of a segment's columns, one per config ("st0",
    "st1", ...; a config whose tree is not worth building is skipped)."""
    out: Dict[str, StarTreeIndex] = {}
    for i, st_cfg in enumerate(configs):
        st = StarTreeIndex.build(
            columns,
            num_docs,
            st_cfg.get("dimensionsSplitOrder", []),
            st_cfg.get("functionColumnPairs", []),
            min_collapse=float(st_cfg.get("minCollapse", 1.1)),
        )
        if st is not None:
            out[f"st{i}"] = st
    return out


def _build_mv_column(f, col: RaggedColumn, num_docs: int) -> ColumnData:
    """Multi-value column: a dictionary over the FLATTENED values + a padded
    [num_docs, max_len] code matrix with per-row lengths; padding cells hold
    code == cardinality (one past the dictionary), which every predicate
    table and range treats as no-match (the JAX package's layout)."""
    flat = np.asarray(col.values)
    flat = flat.astype(object) if f.data_type.is_string_like else flat.astype(f.data_type.np_dtype, copy=False)
    lengths = np.asarray(col.lengths, dtype=np.int32)
    dictionary, flat_codes = Dictionary.build(f.data_type, flat)
    card = dictionary.cardinality
    codes2d = RaggedColumn(flat_codes, lengths).padded(card, min_code_dtype(card + 1))  # +1: the padding code
    stats = collect_stats(f.name, f.data_type, flat, None, card, True)
    stats.num_docs = num_docs  # rows, not elements
    return ColumnData(f.name, f.data_type, dictionary, codes2d, None, None, stats, mv_lengths=lengths)


def _build_vector_column(f, col: RaggedColumn, num_docs: int):
    """Embedding column: raw padded [n, dim] float32 matrix (no dictionary)
    + a VectorIndex of the row-normalized matrix (indexes/vector.py)."""
    lengths = np.asarray(col.lengths, dtype=np.int32)
    mat = RaggedColumn(np.asarray(col.values, dtype=np.float32), lengths).padded(0.0, np.float32)
    flat = mat[np.arange(mat.shape[1])[None, :] < lengths[:, None]]
    stats = collect_stats(f.name, f.data_type, flat.astype(np.float64), None, 0, False)
    stats.num_docs = num_docs
    return (
        ColumnData(f.name, f.data_type, None, None, mat, None, stats, mv_lengths=lengths),
        VectorIndex.build(mat, lengths),
    )


def _wants_dictionary(f, idx_cfg: IndexingConfig) -> bool:
    if f.data_type.is_string_like:
        return True
    if f.name in idx_cfg.no_dictionary_columns:
        return False
    return f.role in (FieldRole.DIMENSION, FieldRole.DATE_TIME)
