"""Per-column statistics collected at segment build time.

Copy of pinot_tpu/segment/stats.py.

Reference parity: pinot-segment-local stats collectors feeding ColumnMetadata
(SegmentColumnarIndexCreator writes min/max/cardinality/sorted into segment
metadata).  Used host-side for segment pruning before any kernel launch
(SegmentPrunerService analog, query/executor.prune_segment) and for the limb
plans of exact integer sums.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from pinot_tpu_torch.spi.schema import DataType


@dataclass
class ColumnStats:
    name: str
    data_type: DataType
    num_docs: int
    cardinality: int
    min_value: Any = None
    max_value: Any = None
    is_sorted: bool = False
    has_nulls: bool = False
    has_dictionary: bool = True
    # partition info for partition-pinned routing (SURVEY.md 2.5)
    partition_id: Optional[int] = None
    num_partitions: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        def _py(v):
            if isinstance(v, np.generic):
                return v.item()
            if isinstance(v, bytes):
                return v.decode("latin-1")
            return v

        return {
            "name": self.name,
            "dataType": self.data_type.value,
            "numDocs": self.num_docs,
            "cardinality": self.cardinality,
            "min": _py(self.min_value),
            "max": _py(self.max_value),
            "sorted": self.is_sorted,
            "hasNulls": self.has_nulls,
            "hasDictionary": self.has_dictionary,
            "partitionId": self.partition_id,
            "numPartitions": self.num_partitions,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ColumnStats":
        dt = DataType(d["dataType"])
        mn, mx = d.get("min"), d.get("max")
        if dt is DataType.BYTES:
            mn = mn.encode("latin-1") if isinstance(mn, str) else mn
            mx = mx.encode("latin-1") if isinstance(mx, str) else mx
        return ColumnStats(
            name=d["name"],
            data_type=dt,
            num_docs=d["numDocs"],
            cardinality=d["cardinality"],
            min_value=mn,
            max_value=mx,
            is_sorted=d.get("sorted", False),
            has_nulls=d.get("hasNulls", False),
            has_dictionary=d.get("hasDictionary", True),
            partition_id=d.get("partitionId"),
            num_partitions=d.get("numPartitions"),
        )


def collect_stats(
    name: str,
    data_type: DataType,
    values: np.ndarray,
    null_mask: Optional[np.ndarray],
    cardinality: int,
    has_dictionary: bool,
) -> ColumnStats:
    """Single-pass stats over the (null-substituted) column values."""
    n = len(values)
    if n == 0:
        return ColumnStats(name, data_type, 0, 0, has_dictionary=has_dictionary)
    if data_type.is_string_like:
        mn, mx = min(values), max(values)
        arr = np.asarray(values, dtype=object)
        is_sorted = bool(np.all(arr[:-1] <= arr[1:])) if n > 1 else True
    else:
        arr = np.asarray(values, dtype=data_type.np_dtype)
        mn, mx = arr.min(), arr.max()
        is_sorted = bool(np.all(arr[:-1] <= arr[1:]))
    return ColumnStats(
        name=name,
        data_type=data_type,
        num_docs=n,
        cardinality=cardinality,
        min_value=mn,
        max_value=mx,
        is_sorted=is_sorted,
        has_nulls=bool(null_mask is not None and null_mask.any()),
        has_dictionary=has_dictionary,
    )
