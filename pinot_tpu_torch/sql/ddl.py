"""SQL DDL: CREATE/DROP TABLE, SHOW TABLES, SHOW CREATE TABLE.

Reference parity: the fork's pinot-sql-ddl module (pinot-sql-ddl/DESIGN.md —
DDL compiled to (Schema, TableConfig) with a round-trip fixed point).
Copy of pinot_tpu/sql/ddl.py (host-only) over the port's parser class: the
same statement gives the same schema and the same SHOW CREATE TABLE text.

Grammar:
  CREATE TABLE name (
      col TYPE [METRIC | DIMENSION | TIME] [MV] [NULLABLE],
      ...,
      PRIMARY KEY (col, ...)
  ) [WITH (key = 'value', ...)]
  DROP TABLE name
  SHOW TABLES
  SHOW CREATE TABLE name

WITH keys map onto TableConfig: invertedIndexColumns, rangeIndexColumns,
bloomFilterColumns, jsonIndexColumns, textIndexColumns, vectorIndexColumns,
sortedColumn, noDictionaryColumns, timeColumnName, retentionDays,
partitionColumn, numPartitions, streamType, upsertMode, comparisonColumn,
dedup (comma-separated lists where plural).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.spi.config import (
    DedupConfig,
    IndexingConfig,
    SegmentsConfig,
    StreamConfig,
    TableConfig,
    UpsertConfig,
)
from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema
from pinot_tpu_torch.sql.parser import _Parser


@dataclass
class DdlStatement:
    kind: str  # create_table | drop_table | show_tables | show_create_table
    table: Optional[str] = None
    schema: Optional[Schema] = None
    config: Optional[TableConfig] = None


_TYPES = {t.value: t for t in DataType}


def is_ddl(sql: str) -> bool:
    head = sql.lstrip().split(None, 1)
    return bool(head) and head[0].lower() in ("create", "drop", "show")


def parse_ddl(sql: str) -> DdlStatement:
    p = _DdlParser(sql)
    return p.parse_ddl()


class _DdlParser(_Parser):
    def parse_ddl(self) -> DdlStatement:
        if self._accept_word("create"):
            self._expect_word("table")
            return self._create_table()
        if self._accept_word("drop"):
            self._expect_word("table")
            return DdlStatement("drop_table", table=self._ident())
        if self._accept_word("show"):
            if self._accept_word("tables"):
                return DdlStatement("show_tables")
            self._expect_word("create")
            self._expect_word("table")
            return DdlStatement("show_create_table", table=self._ident())
        self.fail("expected CREATE / DROP / SHOW")

    # DDL words are plain identifiers to the base lexer
    def _accept_word(self, w: str) -> bool:
        t = self.cur
        if t.kind in ("ident", "kw") and str(t.value).lower() == w:
            self.advance()
            return True
        return False

    def _expect_word(self, w: str) -> None:
        if not self._accept_word(w):
            self.fail(f"expected {w.upper()}")

    def _ident(self) -> str:
        if self.cur.kind not in ("ident",):
            self.fail("expected identifier")
        return self.advance().value

    def _create_table(self) -> DdlStatement:
        name = self._ident()
        self.expect_op("(")
        fields: List[FieldSpec] = []
        pks: List[str] = []
        while True:
            if self._accept_word("primary"):
                self._expect_word("key")
                self.expect_op("(")
                pks.append(self._ident())
                while self.accept_op(","):
                    pks.append(self._ident())
                self.expect_op(")")
            else:
                fields.append(self._column_def())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        props: Dict[str, str] = {}
        if self._accept_word("with"):
            self.expect_op("(")
            while True:
                key = str(self.advance().value)
                self.expect_op("=")
                props[key] = str(self.literal_value())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        self.accept_op(";")
        schema = Schema(name=name, fields=fields, primary_key_columns=pks)
        config = _config_from_props(name, props)
        return DdlStatement("create_table", table=name, schema=schema, config=config)

    def _column_def(self) -> FieldSpec:
        col = self._ident()
        tname = str(self.advance().value).upper()
        if tname not in _TYPES:
            self.fail(f"unknown type {tname} (have {sorted(_TYPES)})")
        dt = _TYPES[tname]
        role = FieldRole.DATE_TIME if dt is DataType.TIMESTAMP else FieldRole.DIMENSION
        single_value = True
        nullable = False
        while True:
            if self._accept_word("metric"):
                role = FieldRole.METRIC
            elif self._accept_word("dimension"):
                role = FieldRole.DIMENSION
            elif self._accept_word("time"):
                role = FieldRole.DATE_TIME
            elif self._accept_word("mv"):
                single_value = False
            elif self._accept_word("nullable"):
                nullable = True
            else:
                break
        return FieldSpec(col, dt, role=role, single_value=single_value, nullable=nullable)


def _split(v: str) -> List[str]:
    return [s.strip() for s in v.split(",") if s.strip()]


def _config_from_props(name: str, props: Dict[str, str]) -> TableConfig:
    idx = IndexingConfig(
        inverted_index_columns=_split(props.get("invertedIndexColumns", "")),
        range_index_columns=_split(props.get("rangeIndexColumns", "")),
        bloom_filter_columns=_split(props.get("bloomFilterColumns", "")),
        json_index_columns=_split(props.get("jsonIndexColumns", "")),
        text_index_columns=_split(props.get("textIndexColumns", "")),
        vector_index_columns=_split(props.get("vectorIndexColumns", "")),
        no_dictionary_columns=_split(props.get("noDictionaryColumns", "")),
        sorted_column=props.get("sortedColumn"),
    )
    seg = SegmentsConfig(
        time_column=props.get("timeColumnName"),
        retention_time_value=int(props["retentionDays"]) if "retentionDays" in props else None,
    )
    upsert = None
    if props.get("upsertMode", "").upper() in ("FULL", "PARTIAL"):
        upsert = UpsertConfig(mode=props["upsertMode"].upper(), comparison_column=props.get("comparisonColumn"))
    dedup = DedupConfig(enabled=True) if str(props.get("dedup", "")).lower() in ("true", "1") else None
    stream = None
    if "streamType" in props:
        stream = StreamConfig(
            stream_type=props["streamType"],
            topic=props.get("topic", ""),
            max_rows_per_segment=int(props.get("maxRowsPerSegment", 1 << 20)),
        )
    return TableConfig(
        name=name,
        indexing=idx,
        segments=seg,
        upsert=upsert,
        dedup=dedup,
        stream=stream,
        partition_column=props.get("partitionColumn"),
        num_partitions=int(props.get("numPartitions", 0)),
    )


def show_create_table(schema: Schema, config: TableConfig) -> str:
    """(Schema, TableConfig) -> CREATE TABLE text (the round-trip fixed
    point: parse_ddl(show_create_table(s, c)) == (s, c))."""
    cols = []
    for f in schema.fields:
        parts = [f.name, f.data_type.value]
        if f.role is FieldRole.METRIC:
            parts.append("METRIC")
        elif f.role is FieldRole.DATE_TIME and f.data_type is not DataType.TIMESTAMP:
            parts.append("TIME")
        if not f.single_value:
            parts.append("MV")
        if f.nullable:
            parts.append("NULLABLE")
        cols.append("  " + " ".join(parts))
    if schema.primary_key_columns:
        cols.append("  PRIMARY KEY (" + ", ".join(schema.primary_key_columns) + ")")
    props: List[Tuple[str, Any]] = []
    idx = config.indexing
    for key, val in (
        ("invertedIndexColumns", ",".join(idx.inverted_index_columns)),
        ("rangeIndexColumns", ",".join(idx.range_index_columns)),
        ("bloomFilterColumns", ",".join(idx.bloom_filter_columns)),
        ("jsonIndexColumns", ",".join(idx.json_index_columns)),
        ("textIndexColumns", ",".join(idx.text_index_columns)),
        ("vectorIndexColumns", ",".join(idx.vector_index_columns)),
        ("noDictionaryColumns", ",".join(idx.no_dictionary_columns)),
        ("sortedColumn", idx.sorted_column or ""),
        ("timeColumnName", config.segments.time_column or ""),
        (
            "retentionDays",
            str(config.segments.retention_time_value) if config.segments.retention_time_value else "",
        ),
        ("partitionColumn", config.partition_column or ""),
        ("numPartitions", str(config.num_partitions) if config.num_partitions else ""),
        ("upsertMode", config.upsert.mode if config.upsert else ""),
        ("comparisonColumn", config.upsert.comparison_column or "" if config.upsert else ""),
        ("dedup", "true" if config.dedup and config.dedup.enabled else ""),
        ("streamType", config.stream.stream_type if config.stream else ""),
    ):
        if val:
            props.append((key, val))
    out = f"CREATE TABLE {schema.name} (\n" + ",\n".join(cols) + "\n)"
    if props:
        out += " WITH (\n" + ",\n".join(f"  {k} = '{v}'" for k, v in props) + "\n)"
    return out
