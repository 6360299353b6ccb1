"""Sorted per-column value dictionaries.

Copy of pinot_tpu/segment/dictionary.py, persistence regions included (the
same regions, so either package loads the other's segments).  Reference parity:
pinot-segment-local SegmentDictionaryCreator + the typed readers
(pinot-segment-spi Dictionary.java:38 — indexOf/insertionIndexOf/get*).
The dictionary is SORTED, which is the load-bearing trick the port keeps:
range predicates on a dict-encoded column become closed-form dictId-range
compares on the code array (no value gather needed on device).

Design deltas vs the reference:
  * One implementation for all types over numpy (object array for strings).
  * build() encodes the whole column at once (np.unique return_inverse;
    string columns through a sorted set, which gives the same values and
    codes faster).
  * Numeric dictionaries can be shipped to the device (values array) so
    projection of a dict-encoded numeric column is a device-side gather;
    string dictionaries stay host-side and the device only sees codes.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dataclass_field
from typing import Optional, Tuple

import numpy as np

from pinot_tpu_torch.spi.schema import DataType

# Sentinel dictId for "value not in dictionary" (Dictionary.NULL_VALUE_INDEX).
NULL_DICT_ID = -1


def min_code_dtype(cardinality: int) -> np.dtype:
    """Smallest unsigned dtype that holds [0, cardinality) codes.

    Byte-aligned host storage; the 4/8/16-bit lane packing of
    segment/packing.py is what ships to the device."""
    if cardinality <= 1 << 8:
        return np.dtype(np.uint8)
    if cardinality <= 1 << 16:
        return np.dtype(np.uint16)
    return np.dtype(np.uint32)


@dataclass
class Dictionary:
    """Immutable sorted dictionary for one column."""

    data_type: DataType
    values: np.ndarray  # sorted ascending; dtype = data_type.np_dtype (object for strings)

    @property
    def cardinality(self) -> int:
        return len(self.values)

    # cache slot, not data: excluded from __init__/__eq__/__repr__ so a
    # poisoned fingerprint cannot be injected via the constructor
    _fp_cache: Optional[str] = dataclass_field(default=None, init=False, compare=False, repr=False)

    def fingerprint(self) -> str:
        """Content hash of the value set — used to detect segments that share
        a key space (aligned dense group-by merges, reduce.py)."""
        if self._fp_cache is None:
            import hashlib

            h = hashlib.blake2b(digest_size=12)
            if self.data_type.is_string_like:
                for v in self.values:
                    b = v if isinstance(v, bytes) else str(v).encode("utf-8")
                    h.update(len(b).to_bytes(4, "little"))  # length-prefix: no delimiter collisions
                    h.update(b)
            else:
                h.update(np.ascontiguousarray(self.values).tobytes())
            object.__setattr__(self, "_fp_cache", h.hexdigest())
        return self._fp_cache

    # -- build -----------------------------------------------------------
    @staticmethod
    def build(data_type: DataType, raw_values: np.ndarray) -> Tuple["Dictionary", np.ndarray]:
        """One pass: sorted unique values + codes for every row.

        Collapses Pinot's two-phase flow (stats collector -> dictionary
        creator -> per-row indexOf) into np.unique(return_inverse), which is
        exactly 'sort unique + searchsorted' fused."""
        if data_type.is_string_like:
            # the JAX package's np.unique over the object array, computed as
            # a sorted set and one dict lookup a row: the same sorted values
            # and codes, without an O(n log n) sort of Python objects
            items = np.asarray(raw_values, dtype=object).reshape(-1).tolist()
            uniq = sorted(set(items))
            values = np.fromiter(uniq, dtype=object, count=len(uniq))  # the objects as they are
            lookup = {v: i for i, v in enumerate(uniq)}
            inverse = np.fromiter(map(lookup.__getitem__, items), dtype=np.int32, count=len(items))
        else:
            arr = np.asarray(raw_values, dtype=data_type.np_dtype)
            values, inverse = np.unique(arr, return_inverse=True)
        d = Dictionary(data_type=data_type, values=values)
        return d, inverse.astype(np.int32)

    # -- lookups ---------------------------------------------------------
    def index_of(self, value) -> int:
        """Exact-match dictId or NULL_DICT_ID (Dictionary.indexOf)."""
        i = int(np.searchsorted(self.values, self._coerce(value)))
        if i < len(self.values) and self.values[i] == self._coerce(value):
            return i
        return NULL_DICT_ID

    def get_values(self, dict_ids: np.ndarray) -> np.ndarray:
        return self.values[np.asarray(dict_ids)]

    def _coerce(self, value):
        """Keep literals semantically intact: numpy compares/searchsorts
        cross-dtype correctly (2.5 lands between 2 and 3 in an int dict and
        equals nothing), whereas casting to the column dtype would truncate
        and match the wrong rows."""
        if isinstance(value, np.generic):
            return value.item()
        return value

    # -- device ----------------------------------------------------------
    def device_values(self) -> Optional[np.ndarray]:
        """Numeric dictionary values for device residency (None for strings).

        64-bit integer dictionaries narrow to int32 when the range fits, as
        in the JAX package (segment/builder.py narrow_ints)."""
        if self.data_type.is_string_like:
            return None
        vals = np.asarray(self.values, dtype=self.data_type.np_dtype)
        if (
            np.issubdtype(vals.dtype, np.integer)
            and vals.dtype.itemsize > 4
            and len(vals)
            and np.iinfo(np.int32).min <= vals[0]
            and vals[-1] <= np.iinfo(np.int32).max
        ):
            return vals.astype(np.int32)
        return vals

    # -- serde (store.py writes these regions) ---------------------------
    def to_regions(self, prefix: str):
        """Yield (name, ndarray) regions. Strings become a utf-8 blob +
        int64 offsets — the V3-single-file analog of Pinot's var-length
        dictionary layout."""
        if self.data_type.is_string_like:
            if self.data_type is DataType.BYTES:
                encoded = [bytes(v) for v in self.values]
            else:
                encoded = [str(v).encode("utf-8") for v in self.values]
            blob = b"".join(encoded)
            offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
            np.cumsum([len(e) for e in encoded], out=offsets[1:])
            yield f"{prefix}.dict.blob", np.frombuffer(blob, dtype=np.uint8)
            yield f"{prefix}.dict.offsets", offsets
        else:
            yield f"{prefix}.dict.values", np.asarray(self.values)

    @staticmethod
    def from_regions(data_type: DataType, regions, prefix: str) -> "Dictionary":
        if data_type.is_string_like:
            blob = regions[f"{prefix}.dict.blob"].tobytes()
            offsets = regions[f"{prefix}.dict.offsets"]
            if data_type is DataType.BYTES:
                vals = [blob[offsets[i]: offsets[i + 1]] for i in range(len(offsets) - 1)]
            else:
                vals = [blob[offsets[i]: offsets[i + 1]].decode("utf-8") for i in range(len(offsets) - 1)]
            values = np.asarray(vals, dtype=object)
        else:
            values = np.asarray(regions[f"{prefix}.dict.values"], dtype=data_type.np_dtype)
        return Dictionary(data_type=data_type, values=values)
