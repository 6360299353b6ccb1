"""Table configuration — per-table knobs (TableConfig analog).

Reference parity: pinot-spi/.../spi/config/table/TableConfig.java:45 (table
name/type, indexing config, segment config, routing, upsert, stream configs).
JSON shape kept close to Pinot's tableConfig JSON for migration.

Copy of pinot_tpu/spi/config.py.  The dict and JSON forms are the JAX
package's, so the coordinator's journal (cluster/journal.py) holds the
same table entries in either package.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class TableType(enum.Enum):
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"


@dataclass
class IndexingConfig:
    """Per-table index declarations (IndexingConfig analog).

    Column lists select which index each column gets; the segment builder
    (segment/builder.py) materializes them, the planner (query/planner.py)
    exploits them — mirroring StandardIndexes (pinot-segment-spi
    StandardIndexes.java:73-157)."""

    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    sorted_column: Optional[str] = None
    bloom_filter_columns: List[str] = field(default_factory=list)
    json_index_columns: List[str] = field(default_factory=list)
    text_index_columns: List[str] = field(default_factory=list)
    vector_index_columns: List[str] = field(default_factory=list)
    # Columns stored raw (no dictionary); metrics default to raw anyway.
    no_dictionary_columns: List[str] = field(default_factory=list)
    # Star-tree index configs (list of dicts: dimensionsSplitOrder,
    # functionColumnPairs, maxLeafRecords) — see indexes/startree.py.
    star_tree_index_configs: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "invertedIndexColumns": self.inverted_index_columns,
            "rangeIndexColumns": self.range_index_columns,
            "sortedColumn": self.sorted_column,
            "bloomFilterColumns": self.bloom_filter_columns,
            "jsonIndexColumns": self.json_index_columns,
            "textIndexColumns": self.text_index_columns,
            "vectorIndexColumns": self.vector_index_columns,
            "noDictionaryColumns": self.no_dictionary_columns,
            "starTreeIndexConfigs": self.star_tree_index_configs,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "IndexingConfig":
        return IndexingConfig(
            inverted_index_columns=d.get("invertedIndexColumns", []),
            range_index_columns=d.get("rangeIndexColumns", []),
            sorted_column=d.get("sortedColumn"),
            bloom_filter_columns=d.get("bloomFilterColumns", []),
            json_index_columns=d.get("jsonIndexColumns", []),
            text_index_columns=d.get("textIndexColumns", []),
            vector_index_columns=d.get("vectorIndexColumns", []),
            no_dictionary_columns=d.get("noDictionaryColumns", []),
            star_tree_index_configs=d.get("starTreeIndexConfigs", []),
        )


@dataclass
class SegmentsConfig:
    """Segment lifecycle config (SegmentsValidationAndRetentionConfig analog):
    time column for retention/time-pruning, retention, replication, and the
    target rows per segment used by builders and realtime sealing."""

    time_column: Optional[str] = None
    retention_time_value: Optional[int] = None
    retention_time_unit: str = "DAYS"
    replication: int = 1
    target_rows_per_segment: int = 1 << 20

    def to_dict(self) -> Dict[str, Any]:
        return {
            "timeColumnName": self.time_column,
            "retentionTimeValue": self.retention_time_value,
            "retentionTimeUnit": self.retention_time_unit,
            "replication": self.replication,
            "targetRowsPerSegment": self.target_rows_per_segment,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SegmentsConfig":
        return SegmentsConfig(
            time_column=d.get("timeColumnName"),
            retention_time_value=d.get("retentionTimeValue"),
            retention_time_unit=d.get("retentionTimeUnit", "DAYS"),
            replication=int(d.get("replication", 1)),
            target_rows_per_segment=int(d.get("targetRowsPerSegment", 1 << 20)),
        )


@dataclass
class UpsertConfig:
    """Upsert mode (pinot-spi UpsertConfig analog): FULL replaces whole rows by
    primary key, PARTIAL merges per-column strategies; comparison column picks
    the winner (latest)."""

    mode: str = "NONE"  # NONE | FULL | PARTIAL
    comparison_column: Optional[str] = None
    partial_upsert_strategies: Dict[str, str] = field(default_factory=dict)
    # metadataTTL (ConcurrentMapPartitionUpsertMetadataManager.java:49):
    # primary keys whose comparison value falls more than this many
    # comparison-units behind the largest seen stop being tracked; 0 = off
    metadata_ttl: float = 0.0
    # deleteRecordColumn: rows with a truthy value here are consistent
    # DELETES — the PK's rows disappear from queries, and the tombstone
    # rejects older out-of-order arrivals until TTL expiry
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
    """Exact-duplicate dropping by primary key at ingest time (pinot-spi
    DedupConfig analog): the FIRST row per PK wins; later rows are dropped
    before indexing."""

    enabled: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return {"dedupEnabled": self.enabled}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DedupConfig":
        return DedupConfig(enabled=bool(d.get("dedupEnabled", True)))


@dataclass
class StreamConfig:
    """Realtime stream binding (pinot-spi stream SPI analog): consumer factory
    name + free-form properties (topic, decoder, end-criteria)."""

    stream_type: str = "memory"  # memory | kafka | file
    topic: str = ""
    decoder: str = "json"
    properties: Dict[str, Any] = field(default_factory=dict)
    # Segment end-criteria (RealtimeSegmentDataManager end-of-segment checks)
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
    table_type: TableType = TableType.OFFLINE
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    segments: SegmentsConfig = field(default_factory=SegmentsConfig)
    upsert: Optional[UpsertConfig] = None
    dedup: Optional[DedupConfig] = None
    stream: Optional[StreamConfig] = None
    # Partitioning for partition-pinned parallelism (SURVEY.md 2.5):
    # column name -> number of partitions.
    partition_column: Optional[str] = None
    num_partitions: int = 0
    tenant: str = "default"
    # Per-table query rate limit (QuotaConfig.maxQueriesPerSecond,
    # enforced at the broker: HelixExternalViewBasedQueryQuotaManager
    # analog); 0 = unlimited
    max_queries_per_second: float = 0.0

    @property
    def table_name_with_type(self) -> str:
        return f"{self.name}_{self.table_type.value}"

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "tableName": self.name,
            "tableType": self.table_type.value,
            "tableIndexConfig": self.indexing.to_dict(),
            "segmentsConfig": self.segments.to_dict(),
            "tenant": self.tenant,
        }
        if self.upsert:
            d["upsertConfig"] = self.upsert.to_dict()
        if self.dedup:
            d["dedupConfig"] = self.dedup.to_dict()
        if self.stream:
            d["streamConfigs"] = self.stream.to_dict()
        if self.partition_column:
            d["partitionColumn"] = self.partition_column
            d["numPartitions"] = self.num_partitions
        if self.max_queries_per_second:
            d["quota"] = {"maxQueriesPerSecond": self.max_queries_per_second}
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TableConfig":
        return TableConfig(
            name=d["tableName"],
            table_type=TableType(d.get("tableType", "OFFLINE")),
            indexing=IndexingConfig.from_dict(d.get("tableIndexConfig", {})),
            segments=SegmentsConfig.from_dict(d.get("segmentsConfig", {})),
            upsert=UpsertConfig.from_dict(d["upsertConfig"]) if d.get("upsertConfig") else None,
            dedup=DedupConfig.from_dict(d["dedupConfig"]) if d.get("dedupConfig") else None,
            stream=StreamConfig.from_dict(d["streamConfigs"]) if d.get("streamConfigs") else None,
            partition_column=d.get("partitionColumn"),
            num_partitions=int(d.get("numPartitions", 0)),
            tenant=d.get("tenant", "default"),
            max_queries_per_second=float(
                (d.get("quota") or {}).get("maxQueriesPerSecond", 0.0) or 0.0
            ),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_json(s: str) -> "TableConfig":
        return TableConfig.from_dict(json.loads(s))
