"""Table configuration — per-table knobs (TableConfig analog).

Trimmed copy of pinot_tpu/spi/config.py: the index declarations the
segment builder reads (inverted, range, bloom, JSON, text and vector
indexes, star-tree configs, the sorted column, raw columns), the segments'
time column and retention, and the settings a CREATE TABLE statement
declares (sql/ddl.py): partitioning and the upsert, dedup and stream
bindings, held as declared (the realtime tables that act on them are a
later slice).  Replication, serialization, table types and quotas come with
the slices that use them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class IndexingConfig:
    """Per-table index declarations (IndexingConfig analog)."""

    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    sorted_column: Optional[str] = None
    bloom_filter_columns: List[str] = field(default_factory=list)
    json_index_columns: List[str] = field(default_factory=list)
    text_index_columns: List[str] = field(default_factory=list)
    vector_index_columns: List[str] = field(default_factory=list)
    # Columns stored raw (no dictionary); metrics default to raw anyway.
    no_dictionary_columns: List[str] = field(default_factory=list)
    # Star-tree index configs (dicts: dimensionsSplitOrder,
    # functionColumnPairs, minCollapse) — see indexes/startree.py.
    star_tree_index_configs: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class SegmentsConfig:
    """Segment settings (SegmentsValidationAndRetentionConfig analog): the
    time column whose (min, max) every segment records as its time range,
    and the retention in days."""

    time_column: Optional[str] = None
    retention_time_value: Optional[int] = None


@dataclass
class UpsertConfig:
    """Upsert mode: FULL replaces whole rows by primary key, PARTIAL merges
    per column; the comparison column picks the winner."""

    mode: str = "NONE"  # NONE | FULL | PARTIAL
    comparison_column: Optional[str] = None


@dataclass
class DedupConfig:
    """Exact-duplicate dropping by primary key at ingest time."""

    enabled: bool = True


@dataclass
class StreamConfig:
    """Realtime stream binding: consumer type, topic and rows a segment."""

    stream_type: str = "memory"  # memory | kafka | file
    topic: str = ""
    max_rows_per_segment: int = 1 << 20


@dataclass
class TableConfig:
    name: str
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    segments: SegmentsConfig = field(default_factory=SegmentsConfig)
    upsert: Optional[UpsertConfig] = None
    dedup: Optional[DedupConfig] = None
    stream: Optional[StreamConfig] = None
    # partition-pinned parallelism: column name and number of partitions
    partition_column: Optional[str] = None
    num_partitions: int = 0
