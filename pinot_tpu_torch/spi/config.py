"""Table configuration — per-table knobs (TableConfig analog).

Trimmed copy of pinot_tpu/spi/config.py: the index declarations the
segment builder reads (inverted, range, bloom, JSON, text and vector
indexes, star-tree configs, the sorted column, raw columns) and the
segments' time column.  Retention and replication, partitioning,
serialization, table types and the upsert, dedup, stream and quota settings
come with the slices that use them.
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
    time column whose (min, max) every segment records as its time range."""

    time_column: Optional[str] = None


@dataclass
class TableConfig:
    name: str
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    segments: SegmentsConfig = field(default_factory=SegmentsConfig)
