"""Pluggable index registry (StandardIndexes analog).

Port of pinot_tpu/indexes/__init__.py.  Each index kind implements
build(...), to_regions(prefix), meta() and from_regions(meta, regions,
prefix); segments persist them inside the single columns.bin
(segment/store.py) and reload them through load_index.  The JSON, text,
vector and star-tree indexes are not ported yet: loading a segment that
holds one raises NotImplementedError naming ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from typing import Any, Dict

from pinot_tpu_torch.indexes.bloom import BloomFilter
from pinot_tpu_torch.indexes.inverted import CompressedInvertedIndex, InvertedIndex, RangeEncodedIndex

_REGISTRY = {
    InvertedIndex.KIND: InvertedIndex,
    CompressedInvertedIndex.KIND: CompressedInvertedIndex,
    RangeEncodedIndex.KIND: RangeEncodedIndex,
    BloomFilter.KIND: BloomFilter,
}
# kinds the JAX package persists whose index classes come with a later slice
_UNPORTED = ("json", "text", "vector", "startree")


def load_index(kind: str, meta: Dict[str, Any], regions, prefix: str):
    # an index's meta may name a more specific implementation than its slot
    # (e.g. "cinverted" stored under the "inverted" slot)
    name = meta.get("kind", kind)
    cls = _REGISTRY.get(name) or _REGISTRY.get(kind)
    if cls is None:
        if name in _UNPORTED or kind in _UNPORTED:
            raise NotImplementedError(
                f"the {name} index is not ported yet (ROADMAP Queue 1 item 5)"
            )
        raise ValueError(f"unknown index kind {kind!r} (have {list(_REGISTRY)})")
    return cls.from_regions(meta, regions, prefix)
