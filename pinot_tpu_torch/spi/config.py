"""Table configuration — per-table knobs (TableConfig analog).

Trimmed copy of pinot_tpu/spi/config.py: the index declarations the
single-table SQL slice reads (inverted, range and bloom indexes, the sorted
column, raw columns) and the segments' time column.  JSON/text/vector/
star-tree indexes, retention and replication, partitioning, serialization,
table types and the upsert, dedup, stream and quota settings come with the
slices that use them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class IndexingConfig:
    """Per-table index declarations (IndexingConfig analog)."""

    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    sorted_column: Optional[str] = None
    bloom_filter_columns: List[str] = field(default_factory=list)
    # Columns stored raw (no dictionary); metrics default to raw anyway.
    no_dictionary_columns: List[str] = field(default_factory=list)


@dataclass
class SegmentsConfig:
    """Segment settings (SegmentsValidationAndRetentionConfig analog): the
    time column whose (min, max) every segment records as its time range."""

    time_column: Optional[str] = None


@dataclass
class TableConfig:
    name: str
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    segments: SegmentsConfig = field(default_factory=SegmentsConfig)
