"""Immutable segment: the unit of storage, distribution and query.

Port of pinot_tpu/segment/segment.py.  Host side: numpy columns with
per-column metadata, dictionaries and indexes (built by segment/builder.py,
or carried over from a JAX-built segment by segment/convert.py).  Device
side: ``to_device(device)`` ships a plain dict of torch tensors —
{col: {"codes" | "codes_packed", "dict", "values", "nulls"}} — and caches it
per device, so repeated queries hit resident tensors.  Static facts
(num_docs, cardinalities, stats) stay host-side for pruning and for the
closed-form predicate constants.

Device dtypes: uint8 codes stay uint8; wider codes ship as int32 (torch's
uint16/uint32 support few operators); packed lane words and bitmap words
ship as int32 views of the uint32 words.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.segment import packing
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.stats import ColumnStats
from pinot_tpu_torch.spi.schema import DataType, Schema


@dataclass
class ColumnData:
    """One single-value column inside a segment (DataSource analog: forward
    index + dictionary + null vector)."""

    name: str
    data_type: DataType
    dictionary: Optional[Dictionary]  # None => raw storage
    codes: Optional[np.ndarray]  # uint8/16/32[num_docs] when dictionary-encoded
    values: Optional[np.ndarray]  # raw storage (numeric) when no dictionary
    nulls: Optional[np.ndarray]  # bool[num_docs] true=null, None if no nulls
    stats: ColumnStats
    # bit-packed forward index (segment/packing.py): codes in `code_bits`
    # lanes of uint32 words; None on raw and wide (>16-bit) columns
    code_bits: Optional[int] = None
    packed: Optional[np.ndarray] = None

    @property
    def has_dictionary(self) -> bool:
        return self.dictionary is not None

    @property
    def cardinality(self) -> int:
        return self.dictionary.cardinality if self.dictionary else self.stats.cardinality

    def decoded(self) -> np.ndarray:
        """Materialize raw values host-side (tests/golden comparisons)."""
        if self.dictionary is not None:
            return self.dictionary.get_values(self.codes)
        return self.values

    def decoded_rows(self, rows: np.ndarray) -> np.ndarray:
        """decoded()[rows] without decoding the whole column: a selection
        reads a handful of rows of a segment."""
        if self.dictionary is not None:
            return self.dictionary.get_values(self.codes[rows])
        return self.values[rows]


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(arr)
    if a.dtype in (np.uint16, np.uint32):
        a = a.astype(np.int32)  # codes only: < 2^31
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class ImmutableSegment:
    """Loaded immutable segment with per-device tensor residency."""

    def __init__(
        self,
        name: str,
        table_name: str,
        schema: Schema,
        columns: Dict[str, ColumnData],
        num_docs: int,
        indexes: Optional[Dict[str, Dict[str, Any]]] = None,
    ):
        self.name = name
        self.table_name = table_name
        self.schema = schema
        self.columns = columns
        self.num_docs = num_docs
        # indexes[kind][column] -> index object (indexes/inverted.py)
        self.indexes: Dict[str, Dict[str, Any]] = indexes or {}
        # upsert validDocIds: not produced by this slice's builder
        self.valid_docs: Optional[np.ndarray] = None
        self._device_cache: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
        self._device_lock = threading.Lock()

    def column(self, name: str) -> ColumnData:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"segment {self.name} has no column {name!r}") from None

    @staticmethod
    def _stage_entry(c: ColumnData, use_packed: bool, device: torch.device) -> Dict[str, torch.Tensor]:
        """One column's host->device copy."""
        entry: Dict[str, torch.Tensor] = {}
        if use_packed:
            entry["codes_packed"] = packing.words_to_torch(c.packed, device)
        elif c.codes is not None:
            entry["codes"] = _to_tensor(c.codes, device)
        if c.codes is not None and c.dictionary is not None:
            dvals = c.dictionary.device_values()
            if dvals is not None:
                entry["dict"] = _to_tensor(dvals, device)
        if c.values is not None:
            entry["values"] = _to_tensor(c.values, device)
        if c.nulls is not None:
            entry["nulls"] = _to_tensor(c.nulls.astype(bool), device)
        return entry

    def to_device(
        self,
        device: DeviceLike = None,
        columns: Optional[List[str]] = None,
        packed_codes: bool = False,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Ship column arrays to `device` (None: CUDA, raising without it);
        returns {column: entry}.  Entries are cached per device — segments
        are immutable.  packed_codes=True ships bit-packed columns as int32
        lane words under "codes_packed" instead of widened "codes"; the two
        shapes cache under distinct keys."""
        dev = resolve_device(device)
        cols = columns or list(self.columns)
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for cname in cols:
            c = self.column(cname)
            use_packed = bool(packed_codes and c.packed is not None)
            key = f"{cname}#packed" if use_packed else cname
            with self._device_lock:
                entry = self._device_cache.setdefault(str(dev), {}).get(key)
            if entry is None:
                entry = self._stage_entry(c, use_packed, dev)
                with self._device_lock:
                    entry = self._device_cache.setdefault(str(dev), {}).setdefault(key, entry)
            out[cname] = entry
        return out
