"""Schema / field specs — the L0 data-model contract.

Copy of pinot_tpu/spi/schema.py (host-only; the port keeps its own copy and
imports nothing of the JAX package).  Reference parity: pinot-spi Schema.java
and FieldSpec.java (DIMENSION/METRIC/DATE_TIME roles, data types,
single/multi-value flags, nullability and default null values).  Types map
onto numpy dtypes; segment/segment.py maps those onto torch dtypes.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


class DataType(enum.Enum):
    """Column storage types (FieldSpec.DataType analog).

    Device representation notes:
      INT/LONG      -> int32/int64 arrays (or dict codes if dict-encoded)
      FLOAT/DOUBLE  -> float32/float64
      BOOLEAN       -> uint8 (0/1)
      TIMESTAMP     -> int64 epoch millis
      STRING/BYTES  -> always dictionary-encoded; device sees int codes only,
                       the value dictionary stays host-side (SURVEY.md section 7
                       "Strings/bytes on device").
      JSON          -> stored as STRING; JSON index provides JSON_MATCH.
    """

    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BOOLEAN = "BOOLEAN"
    TIMESTAMP = "TIMESTAMP"
    STRING = "STRING"
    BYTES = "BYTES"
    JSON = "JSON"

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_string_like(self) -> bool:
        return self in (DataType.STRING, DataType.BYTES, DataType.JSON)

    @property
    def np_dtype(self) -> np.dtype:
        """Numpy dtype of raw (non-dict) storage for this type."""
        return _NP_DTYPES[self]

    @property
    def null_placeholder(self) -> Any:
        """Default value substituted for nulls in the forward index
        (Pinot's FieldSpec default-null-value semantics)."""
        return _NULL_PLACEHOLDER[self]


_NUMERIC = frozenset(
    {DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE, DataType.TIMESTAMP, DataType.BOOLEAN}
)

_NP_DTYPES = {
    DataType.INT: np.dtype(np.int32),
    DataType.LONG: np.dtype(np.int64),
    DataType.FLOAT: np.dtype(np.float32),
    DataType.DOUBLE: np.dtype(np.float64),
    DataType.BOOLEAN: np.dtype(np.uint8),
    DataType.TIMESTAMP: np.dtype(np.int64),
    DataType.STRING: np.dtype(object),
    DataType.BYTES: np.dtype(object),
    DataType.JSON: np.dtype(object),
}

_NULL_PLACEHOLDER = {
    DataType.INT: np.int32(np.iinfo(np.int32).min),
    DataType.LONG: np.int64(np.iinfo(np.int64).min),
    DataType.FLOAT: np.float32("-inf"),
    DataType.DOUBLE: np.float64("-inf"),
    DataType.BOOLEAN: np.uint8(0),
    DataType.TIMESTAMP: np.int64(0),
    DataType.STRING: "null",
    DataType.BYTES: b"",
    DataType.JSON: "null",
}


class FieldRole(enum.Enum):
    """Field category (FieldSpec.FieldType analog): dimensions are
    dictionary-encoded by default and filterable/groupable; metrics default to
    raw storage and are aggregated; DATE_TIME carries time semantics used for
    retention and time pruning."""

    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    DATE_TIME = "DATE_TIME"


@dataclass
class FieldSpec:
    """One column's declaration (pinot-spi FieldSpec analog)."""

    name: str
    data_type: DataType
    role: FieldRole = FieldRole.DIMENSION
    single_value: bool = True
    nullable: bool = False
    # DATE_TIME only: format/granularity strings, kept for config parity.
    datetime_format: Optional[str] = None
    datetime_granularity: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "dataType": self.data_type.value,
            "role": self.role.value,
            "singleValue": self.single_value,
            "nullable": self.nullable,
        }
        if self.datetime_format:
            d["format"] = self.datetime_format
        if self.datetime_granularity:
            d["granularity"] = self.datetime_granularity
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FieldSpec":
        return FieldSpec(
            name=d["name"],
            data_type=DataType(d["dataType"]),
            role=FieldRole(d.get("role", "DIMENSION")),
            single_value=d.get("singleValue", True),
            nullable=d.get("nullable", False),
            datetime_format=d.get("format"),
            datetime_granularity=d.get("granularity"),
        )


@dataclass
class Schema:
    """Table schema: ordered field specs + helpers (Schema.java analog).

    JSON shape intentionally close to Pinot's schema JSON
    (dimensionFieldSpecs/metricFieldSpecs/dateTimeFieldSpecs) so users of the
    reference can migrate configs mechanically."""

    name: str
    fields: List[FieldSpec] = field(default_factory=list)
    primary_key_columns: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._by_name: Dict[str, FieldSpec] = {f.name: f for f in self.fields}
        if len(self._by_name) != len(self.fields):
            raise ValueError(f"duplicate column names in schema {self.name}")

    # -- lookups ---------------------------------------------------------
    def field(self, name: str) -> FieldSpec:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"column '{name}' not in schema '{self.name}' (has {list(self._by_name)})") from None

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def dimension_columns(self) -> List[str]:
        return [f.name for f in self.fields if f.role is FieldRole.DIMENSION]

    @property
    def metric_columns(self) -> List[str]:
        return [f.name for f in self.fields if f.role is FieldRole.METRIC]

    @property
    def datetime_columns(self) -> List[str]:
        return [f.name for f in self.fields if f.role is FieldRole.DATE_TIME]

    # -- serde -----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "schemaName": self.name,
            "dimensionFieldSpecs": [f.to_dict() for f in self.fields if f.role is FieldRole.DIMENSION],
            "metricFieldSpecs": [f.to_dict() for f in self.fields if f.role is FieldRole.METRIC],
            "dateTimeFieldSpecs": [f.to_dict() for f in self.fields if f.role is FieldRole.DATE_TIME],
        }
        if self.primary_key_columns:
            d["primaryKeyColumns"] = list(self.primary_key_columns)
        d["fieldOrder"] = self.column_names
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Schema":
        fields: List[FieldSpec] = []
        for key, role in (
            ("dimensionFieldSpecs", FieldRole.DIMENSION),
            ("metricFieldSpecs", FieldRole.METRIC),
            ("dateTimeFieldSpecs", FieldRole.DATE_TIME),
        ):
            for fd in d.get(key, []):
                fd = dict(fd)
                fd.setdefault("role", role.value)
                fields.append(FieldSpec.from_dict(fd))
        order = d.get("fieldOrder")
        if order:
            pos = {n: i for i, n in enumerate(order)}
            fields.sort(key=lambda f: pos.get(f.name, len(pos)))
        return Schema(
            name=d["schemaName"],
            fields=fields,
            primary_key_columns=list(d.get("primaryKeyColumns", [])),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_json(s: str) -> "Schema":
        return Schema.from_dict(json.loads(s))
