"""Table configuration — per-table knobs (TableConfig analog).

Trimmed copy of pinot_tpu/spi/config.py: the index declarations the
single-table SQL slice reads.  Bloom/JSON/text/vector/star-tree indexes,
segment and retention settings, partitioning, serialization, table types and
the upsert, dedup, stream and quota settings come with the slices that use
them.
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
    # Columns stored raw (no dictionary); metrics default to raw anyway.
    no_dictionary_columns: List[str] = field(default_factory=list)


@dataclass
class TableConfig:
    name: str
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
