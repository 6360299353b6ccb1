"""Pluggable index registry (StandardIndexes analog).

Port of pinot_tpu/indexes/__init__.py.  Each index kind implements
build(...), to_regions(prefix), meta() and from_regions(meta, regions,
prefix); segments persist them inside the single columns.bin
(segment/store.py) and reload them through load_index, in the JAX
package's region layout, so either package loads the other's indexes.
"""
from __future__ import annotations

from typing import Any, Dict

from pinot_tpu_torch.indexes.bloom import BloomFilter
from pinot_tpu_torch.indexes.inverted import CompressedInvertedIndex, InvertedIndex, RangeEncodedIndex
from pinot_tpu_torch.indexes.jsonidx import JsonIndex
from pinot_tpu_torch.indexes.startree import StarTreeIndex
from pinot_tpu_torch.indexes.text import TextIndex
from pinot_tpu_torch.indexes.vector import VectorIndex

_REGISTRY = {
    InvertedIndex.KIND: InvertedIndex,
    CompressedInvertedIndex.KIND: CompressedInvertedIndex,
    RangeEncodedIndex.KIND: RangeEncodedIndex,
    BloomFilter.KIND: BloomFilter,
    StarTreeIndex.KIND: StarTreeIndex,
    JsonIndex.KIND: JsonIndex,
    TextIndex.KIND: TextIndex,
    VectorIndex.KIND: VectorIndex,
}


def load_index(kind: str, meta: Dict[str, Any], regions, prefix: str):
    # an index's meta may name a more specific implementation than its slot
    # (e.g. "cinverted" stored under the "inverted" slot)
    cls = _REGISTRY.get(meta.get("kind", kind)) or _REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"unknown index kind {kind!r} (have {list(_REGISTRY)})")
    return cls.from_regions(meta, regions, prefix)
