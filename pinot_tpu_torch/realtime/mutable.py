"""Mutable (consuming) segment: growable columns + append dictionaries.

Copy of pinot_tpu/realtime/mutable.py (host-only), building through the
port's segment/builder.py.  One addition: a superseded snapshot (the row
count moved on, or the segment sealed) releases its device columns at
once.  The planner's plan cache keeps closures over the segments they were
planned on, so an old snapshot object can outlive its last query; its
device tensors must not.

Reference parity: pinot-segment-local MutableSegmentImpl.index
(MutableSegmentImpl.java:638) — per-row ingest into growable forward indexes
and insertion-order dictionaries, queryable while consuming.

Re-design (TPU-first): the reference serves queries directly off mutating
per-row structures; a TPU kernel needs dense arrays and static shapes.  So
ingest appends O(1) into host buffers (string-like and dictionary columns
through an *unsorted append dictionary* — value->code hash map, values in
insertion order), and the query path materializes a cheap columnar
*snapshot* — an ImmutableSegment built vectorized over the buffered rows,
cached by row count.  Snapshot builds skip the heavyweight indexes (bitmap /
star-tree) and segment sorting; the sealed build (seal()) runs the full
configured pipeline.  This is the mutable/immutable split the reference gets
by swapping MutableSegmentImpl for ImmutableSegmentImpl at commit time
(RealtimeSegmentDataManager.java:933), with the extra step that *every*
snapshot is already in the immutable (device-friendly) layout.
"""
from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional

import numpy as np

from pinot_tpu_torch.realtime.upsert import _as_elems
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.spi.config import TableConfig
from pinot_tpu_torch.spi.schema import DataType, Schema


class AppendDictionary:
    """Unsorted insertion-order dictionary (MutableDictionary analog).

    index() returns a stable code per distinct value in O(1); codes are
    remapped to the sorted immutable dictionary at snapshot/seal time."""

    __slots__ = ("values", "_codes")

    def __init__(self) -> None:
        self.values: List[Any] = []
        self._codes: Dict[Any, int] = {}

    def index(self, value: Any) -> int:
        code = self._codes.get(value)
        if code is None:
            code = len(self.values)
            self._codes[value] = code
            self.values.append(value)
        return code

    def indexOf(self, value: Any) -> int:
        return self._codes.get(value, -1)

    @property
    def cardinality(self) -> int:
        return len(self.values)


class MutableSegment:
    """Growable columnar segment; queryable through snapshot()."""

    def __init__(
        self,
        schema: Schema,
        name: str,
        table_config: Optional[TableConfig] = None,
        start_offset: int = 0,
    ):
        self.schema = schema
        self.name = name
        self.config = table_config or TableConfig(name=schema.name)
        self.start_offset = start_offset
        self.creation_time_ms = int(time.time() * 1000)
        self._dicts: Dict[str, AppendDictionary] = {}
        self._buffers: Dict[str, List[Any]] = {}
        self._null_counts: Dict[str, int] = {}
        self._mv: set = set()
        for f in schema.fields:
            if not f.single_value:
                # MV realtime (round 5, VERDICT r4 #10): buffers hold tuples
                # of coerced elements; NULL/missing ingests as the empty
                # tuple (Pinot's MV default) — MutableSegmentImpl.java:638
                # wires the same per-row MV forward index
                self._mv.add(f.name)
            self._buffers[f.name] = []
            self._null_counts[f.name] = 0
            if f.data_type.is_string_like and f.name not in self._mv:
                # MV strings buffer decoded tuples directly (no append dict)
                self._dicts[f.name] = AppendDictionary()
        self._num_docs = 0
        self._snapshot: Optional[ImmutableSegment] = None
        self._snapshot_docs = -1
        # guards buffers/dicts against a threaded consumer (run_forever)
        # racing snapshot()/seal() readers — one writer, cheap lock
        self._lock = threading.RLock()

    # -- ingest ----------------------------------------------------------
    def index(self, row: Dict[str, Any]) -> int:
        """Ingest one decoded row; returns its docId (MutableSegmentImpl.index).

        The record pipeline (type coercion + null substitution) runs here so
        buffers always hold schema-typed values."""
        with self._lock:
            return self._index_locked(row)

    def _index_locked(self, row: Dict[str, Any]) -> int:
        for f in self.schema.fields:
            v = row.get(f.name)
            buf = self._buffers[f.name]
            if f.name in self._mv:
                buf.append(tuple(_coerce(f.data_type, e) for e in _as_elems(v)))
                continue
            if v is None or (isinstance(v, float) and np.isnan(v)):
                if not f.nullable:
                    v = f.data_type.null_placeholder
                    if f.data_type.is_string_like:
                        buf.append(self._dicts[f.name].index(v))
                        continue
                    buf.append(v)
                    continue
                self._null_counts[f.name] += 1
                buf.append(None)
                continue
            d = self._dicts.get(f.name)
            if d is not None:
                buf.append(d.index(_coerce(f.data_type, v)))
            else:
                buf.append(_coerce(f.data_type, v))
        self._num_docs += 1
        return self._num_docs - 1

    def index_batch(self, rows: List[Dict[str, Any]]) -> None:
        for r in rows:
            self.index(r)

    @property
    def num_docs(self) -> int:
        with self._lock:
            return self._num_docs

    def value_at(self, column: str, doc_id: int) -> Any:
        """Point read of one ingested value (upsert comparison reads)."""
        with self._lock:
            v = self._buffers[column][doc_id]
            if column in self._mv:
                return v  # tuple of coerced elements
            d = self._dicts.get(column)
            if v is None or d is None:
                return v
            return d.values[v]

    # -- query facade ----------------------------------------------------
    def column_values(self, column: str) -> np.ndarray:
        """Materialize one column (insertion order) as an object/typed array."""
        with self._lock:
            return self._column_values_locked(column)

    def _column_values_locked(self, column: str) -> np.ndarray:
        f = self.schema.field(column)
        buf = self._buffers[column]
        if column in self._mv:
            out = np.empty(len(buf), dtype=object)
            for i, t in enumerate(buf):
                out[i] = t
            return out
        d = self._dicts.get(column)
        if d is not None:
            vals = np.asarray(d.values, dtype=object)
            out = np.empty(len(buf), dtype=object)
            codes = np.array([c if c is not None else -1 for c in buf], dtype=np.int64)
            ok = codes >= 0
            out[ok] = vals[codes[ok]]
            out[~ok] = None
            return out
        if self._null_counts[column]:
            return np.asarray(buf, dtype=object)
        return np.asarray(buf, dtype=f.data_type.np_dtype)

    def snapshot(self) -> ImmutableSegment:
        """Columnar view of all rows ingested so far, cached by row count.

        Round 5 (VERDICT r4 #10): snapshots now build the table's configured
        inverted/range/bloom/json/text/vector indexes too — consuming-
        segment queries take the same index-accelerated paths as sealed ones
        (RealtimeLuceneTextIndex / realtime inverted-index analog; the
        reference maintains them incrementally, we rebuild per snapshot,
        amortized by the row-count cache).  Rows keep INSERTION ORDER (no
        segment sort — upsert validDocIds reference snapshot docids) and
        star-trees stay seal-only."""
        with self._lock:
            if self._snapshot is not None and self._snapshot_docs == self._num_docs:
                return self._snapshot
            idx = self.config.indexing
            snap_cfg = replace(
                self.config,
                indexing=replace(idx, sorted_column=None, star_tree_index_configs=[]),
            )
            data = {f.name: self.column_values(f.name) for f in self.schema.fields}
            seg = build_segment(self.schema, data, self.name, snap_cfg)
            seg.in_memory = True  # consuming segments are not yet durable
            self.release_snapshot()
            self._snapshot = seg
            self._snapshot_docs = self._num_docs
            return seg

    def release_snapshot(self) -> None:
        """Drop the cached snapshot and free its device columns (a query
        that already holds them keeps its own references)."""
        with self._lock:
            if self._snapshot is not None:
                self._snapshot.release_device()
            self._snapshot = None
            self._snapshot_docs = -1

    # -- seal ------------------------------------------------------------
    def seal(self, output_dir: Optional[str] = None) -> ImmutableSegment:
        """Final immutable build with the table's FULL indexing config
        (segment sort, bitmap indexes, star-trees) — the build the reference
        runs in RealtimeSegmentDataManager.buildSegmentInternal."""
        with self._lock:
            data = {f.name: self.column_values(f.name) for f in self.schema.fields}
            return build_segment(self.schema, data, self.name, self.config, output_dir=output_dir)


def _coerce(dt: DataType, v: Any):
    if dt is DataType.STRING or dt is DataType.JSON:
        return v if isinstance(v, str) else str(v)
    if dt is DataType.BYTES:
        return v if isinstance(v, bytes) else bytes(v)
    if dt in (DataType.INT, DataType.LONG, DataType.TIMESTAMP):
        return int(v)
    if dt is DataType.BOOLEAN:
        return int(bool(v))
    return float(v)
