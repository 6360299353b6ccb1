"""Table configuration — per-table knobs (TableConfig analog).

Trimmed copy of pinot_tpu/spi/config.py: the index declarations the
segment builder reads (inverted, range, bloom, JSON, text and vector
indexes, star-tree configs, the sorted column, raw columns), the segments'
time column and retention, and the settings a CREATE TABLE statement
declares (sql/ddl.py): partitioning and the upsert, dedup and stream
bindings that the realtime tables (realtime/) act on, with the JAX
package's dict forms of those three.  Replication, table types and quotas
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
    time column whose (min, max) every segment records as its time range,
    and the retention in days."""

    time_column: Optional[str] = None
    retention_time_value: Optional[int] = None


@dataclass
class UpsertConfig:
    """Upsert mode: FULL replaces whole rows by primary key, PARTIAL merges
    per column by strategy; the comparison column picks the winner."""

    mode: str = "NONE"  # NONE | FULL | PARTIAL
    comparison_column: Optional[str] = None
    partial_upsert_strategies: Dict[str, str] = field(default_factory=dict)
    # metadataTTL: primary keys whose comparison value trails the largest
    # seen by more than this stop being tracked; 0 = off
    metadata_ttl: float = 0.0
    # deleteRecordColumn: a row with a truthy value here deletes its key
    delete_record_column: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "comparisonColumn": self.comparison_column,
            "partialUpsertStrategies": self.partial_upsert_strategies,
            "metadataTTL": self.metadata_ttl,
            "deleteRecordColumn": self.delete_record_column,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "UpsertConfig":
        return UpsertConfig(
            mode=d.get("mode", "NONE"),
            comparison_column=d.get("comparisonColumn"),
            partial_upsert_strategies=d.get("partialUpsertStrategies", {}),
            metadata_ttl=float(d.get("metadataTTL", 0.0) or 0.0),
            delete_record_column=d.get("deleteRecordColumn"),
        )


@dataclass
class DedupConfig:
    """Exact-duplicate dropping by primary key at ingest time: the first row
    of a key wins."""

    enabled: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return {"dedupEnabled": self.enabled}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DedupConfig":
        return DedupConfig(enabled=bool(d.get("dedupEnabled", True)))


@dataclass
class StreamConfig:
    """Realtime stream binding: consumer type, topic, decoder, free-form
    properties (a file stream's "path") and the segment end criteria."""

    stream_type: str = "memory"  # memory | kafka | file
    topic: str = ""
    decoder: str = "json"
    properties: Dict[str, Any] = field(default_factory=dict)
    max_rows_per_segment: int = 1 << 20
    max_segment_seconds: int = 6 * 3600

    def to_dict(self) -> Dict[str, Any]:
        return {
            "streamType": self.stream_type,
            "topic": self.topic,
            "decoder": self.decoder,
            "properties": self.properties,
            "maxRowsPerSegment": self.max_rows_per_segment,
            "maxSegmentSeconds": self.max_segment_seconds,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "StreamConfig":
        return StreamConfig(
            stream_type=d.get("streamType", "memory"),
            topic=d.get("topic", ""),
            decoder=d.get("decoder", "json"),
            properties=d.get("properties", {}),
            max_rows_per_segment=int(d.get("maxRowsPerSegment", 1 << 20)),
            max_segment_seconds=int(d.get("maxSegmentSeconds", 6 * 3600)),
        )


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
