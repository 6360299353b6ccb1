"""Carry a segment's host state across from the JAX package.

``segment_from_numpy(meta, arrays)`` rebuilds a port segment from plain
metadata and numpy arrays — the state a pinot_tpu ImmutableSegment holds on
the host — without importing pinot_tpu.  The result answers queries exactly
as the JAX segment does: same dictionaries, codes, packed words, null masks,
stats and index bitmaps.

meta:
    {"segmentName": str, "tableName": str, "numDocs": int,
     "schema": Schema.to_dict(),
     "columns": {name: {"stats": ColumnStats.to_dict(), "codeBits": int | None}},
     "indexes": {"range": [column, ...], "inverted": [column, ...]}}
arrays (per column / index, absent when the segment has none):
    "<col>.dict"    sorted dictionary values (object array for strings)
    "<col>.codes"   dictionary codes          "<col>.packed"  lane words
    "<col>.values"  raw storage               "<col>.nulls"   bool null mask
    "<col>.range.prefix"        range-index prefix bitmaps (card+1, words)
    "<col>.inverted.bitmaps"    inverted bitmaps (card, words); a JAX
                                posting-list index carries across densified
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from pinot_tpu_torch.indexes.inverted import InvertedIndex, RangeEncodedIndex
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.segment import ColumnData, ImmutableSegment
from pinot_tpu_torch.segment.stats import ColumnStats
from pinot_tpu_torch.spi.schema import Schema


def segment_from_numpy(meta: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> ImmutableSegment:
    schema = Schema.from_dict(meta["schema"])
    num_docs = int(meta["numDocs"])
    columns: Dict[str, ColumnData] = {}
    for name, cm in meta["columns"].items():
        stats = ColumnStats.from_dict(cm["stats"])
        dt = stats.data_type
        nulls = arrays.get(f"{name}.nulls")
        if f"{name}.dict" in arrays:
            values = np.asarray(arrays[f"{name}.dict"], dtype=dt.np_dtype)
            dictionary = Dictionary(data_type=dt, values=values)
            bits = cm.get("codeBits")
            columns[name] = ColumnData(
                name, dt, dictionary, np.asarray(arrays[f"{name}.codes"]), None,
                None if nulls is None else np.asarray(nulls, dtype=bool), stats,
                code_bits=int(bits) if bits else None,
                packed=np.asarray(arrays[f"{name}.packed"], dtype=np.uint32) if bits else None,
            )
        else:
            columns[name] = ColumnData(
                name, dt, None, None, np.asarray(arrays[f"{name}.values"]),
                None if nulls is None else np.asarray(nulls, dtype=bool), stats,
            )
    indexes: Dict[str, Dict[str, Any]] = {}
    for name in meta.get("indexes", {}).get("range", []):
        indexes.setdefault("range", {})[name] = RangeEncodedIndex(
            np.asarray(arrays[f"{name}.range.prefix"], dtype=np.uint32), num_docs
        )
    for name in meta.get("indexes", {}).get("inverted", []):
        indexes.setdefault("inverted", {})[name] = InvertedIndex(
            np.asarray(arrays[f"{name}.inverted.bitmaps"], dtype=np.uint32), num_docs
        )
    return ImmutableSegment(
        name=meta["segmentName"],
        table_name=meta["tableName"],
        schema=schema,
        columns=columns,
        num_docs=num_docs,
        indexes=indexes,
    )
