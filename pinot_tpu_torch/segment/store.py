"""Segment persistence: one metadata.json + one aligned binary file.

Copy of pinot_tpu/segment/store.py, byte for byte the same format, so a
segment either package writes loads in the other.  Reference parity: Pinot
V3 single-file layout — all column indexes packed into `columns.psf` with an
`index_map` of (offset, size) entries.  Re-design: the region table lives in
metadata.json with dtype+shape so every region loads as a zero-copy
np.memmap (Pinot's ReadMode.mmap), ready for a host-to-device copy.

Layout of columns.bin: regions back-to-back, each aligned to 64 bytes.

Durability: both files commit via tmp-fsync-replace (data first, then the
metadata that references it — a crash between the two leaves the OLD
committed metadata pointing at the OLD data, or no segment at all, never a
torn one).  metadata.json carries the CRC32 of columns.bin, verified on
load(verify=True) so a corrupt local copy is detected (SegmentCorruptError)
instead of silently serving garbage.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np

from pinot_tpu_torch.spi.filesystem import durable_write_bytes, fsync_dir
from pinot_tpu_torch.utils.crashpoints import crash_point

ALIGN = 64
DATA_FILE = "columns.bin"
META_FILE = "metadata.json"
FORMAT_VERSION = 1


class SegmentCorruptError(RuntimeError):
    """Segment data does not match its committed metadata (bad CRC or a
    missing/short data file) — the local copy must be discarded and
    re-fetched from the deep store."""


def write_segment(path: str, metadata: Dict[str, Any], regions: Iterable[Tuple[str, np.ndarray]]) -> None:
    """Write metadata + binary regions atomically (tmp + fsync + rename)."""
    os.makedirs(path, exist_ok=True)
    region_table: List[Dict[str, Any]] = []
    tmp_data = os.path.join(path, DATA_FILE + ".tmp")
    offset = 0
    crc = 0
    with open(tmp_data, "wb") as f:
        for name, arr in regions:
            arr = np.ascontiguousarray(arr)
            pad = (-offset) % ALIGN
            if pad:
                f.write(b"\x00" * pad)
                crc = zlib.crc32(b"\x00" * pad, crc)
                offset += pad
            raw = arr.tobytes()
            f.write(raw)
            crc = zlib.crc32(raw, crc)
            region_table.append(
                {
                    "name": name,
                    "offset": offset,
                    "nbytes": len(raw),
                    "dtype": arr.dtype.str,
                    "shape": list(arr.shape),
                }
            )
            offset += len(raw)
        crash_point("segment.write.after_data_write")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_data, os.path.join(path, DATA_FILE))
    crash_point("segment.write.after_data_replace")

    meta = dict(metadata)
    meta["formatVersion"] = FORMAT_VERSION
    meta["regions"] = region_table
    meta["dataBytes"] = offset
    meta["dataCrc32"] = crc
    durable_write_bytes(
        os.path.join(path, META_FILE),
        json.dumps(meta, indent=1).encode("utf-8"),
        crash_prefix="segment.write.meta",
    )
    fsync_dir(path)


def data_crc32(path: str, chunk_bytes: int = 1 << 22) -> int:
    """Streamed CRC32 of a segment's columns.bin."""
    crc = 0
    with open(os.path.join(path, DATA_FILE), "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc


def verify_segment(path: str) -> Dict[str, Any]:
    """Check the segment's data file against its committed metadata (size +
    CRC32).  Returns the parsed metadata on success; raises
    SegmentCorruptError on any mismatch.  Pre-CRC segments (no dataCrc32
    field) verify by size alone."""
    meta_path = os.path.join(path, META_FILE)
    data_path = os.path.join(path, DATA_FILE)
    if not os.path.isfile(meta_path):
        raise SegmentCorruptError(f"segment {path}: missing {META_FILE}")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise SegmentCorruptError(f"segment {path}: unreadable {META_FILE}: {e}") from e
    expect_bytes = meta.get("dataBytes")
    if expect_bytes is None:
        regions = meta.get("regions", [])
        expect_bytes = max((r["offset"] + r["nbytes"] for r in regions), default=0)
    if not os.path.isfile(data_path):
        if expect_bytes:
            raise SegmentCorruptError(f"segment {path}: missing {DATA_FILE}")
        return meta
    size = os.path.getsize(data_path)
    if size < expect_bytes:
        raise SegmentCorruptError(
            f"segment {path}: {DATA_FILE} is {size} bytes, metadata commits {expect_bytes}"
        )
    expect_crc = meta.get("dataCrc32")
    if expect_crc is not None and data_crc32(path) != expect_crc:
        raise SegmentCorruptError(f"segment {path}: {DATA_FILE} CRC32 mismatch")
    return meta


class RegionMap(Mapping[str, np.ndarray]):
    """Lazy mmap view over columns.bin keyed by region name."""

    def __init__(self, path: str, meta: Dict[str, Any]):
        self._data_path = os.path.join(path, DATA_FILE)
        self._table = {r["name"]: r for r in meta["regions"]}
        self._cache: Dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cache:
            r = self._table[name]
            if r["nbytes"] == 0:
                self._cache[name] = np.empty(tuple(r["shape"]), dtype=np.dtype(r["dtype"]))
            else:
                self._cache[name] = np.memmap(
                    self._data_path,
                    mode="r",
                    dtype=np.dtype(r["dtype"]),
                    offset=r["offset"],
                    shape=tuple(r["shape"]),
                )
        return self._cache[name]

    def __contains__(self, name: object) -> bool:
        return name in self._table

    def __iter__(self):
        return iter(self._table)

    def __len__(self) -> int:
        return len(self._table)


def read_segment(path: str, verify: bool = False) -> Tuple[Dict[str, Any], RegionMap]:
    if verify:
        meta = verify_segment(path)
    else:
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
    if meta.get("formatVersion") != FORMAT_VERSION:
        raise ValueError(f"unsupported segment format version {meta.get('formatVersion')}")
    return meta, RegionMap(path, meta)
