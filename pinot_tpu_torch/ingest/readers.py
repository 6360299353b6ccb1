"""Input-format record readers: CSV and JSON lines.

Port of pinot_tpu/ingest/readers.py.  Reference parity:
pinot-plugins/pinot-input-format record readers (CSV, JSON) feeding the
segment builder.  Readers emit COLUMN-major numpy arrays (what
build_segment wants) instead of per-row GenericRow objects.  The CSV parse
is the JAX package's Python path (the csv module; the JAX package's native
parser, native/csv.cc, gives the same fields and is not ported): quoted
fields, doubled quotes and quoted newlines, and a row whose arity differs
from the header's raises ValueError.
"""
from __future__ import annotations

import csv
import io
import json
from typing import Any, Dict, List, Optional

import numpy as np

from pinot_tpu_torch.spi.schema import DataType, Schema


def read_csv_columns(
    path: str,
    columns: Optional[List[str]] = None,
    delimiter: str = ",",
    schema: Optional[Schema] = None,
) -> Dict[str, np.ndarray]:
    """CSV file -> {column: np array}, header row required."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"\n")
    if header_end < 0:
        raise ValueError(f"{path}: no header row")
    header = [h.strip().strip('"') for h in data[:header_end].decode("utf-8").split(delimiter)]
    body = data[header_end + 1 :]
    ncols = len(header)

    fields = _parse_fields(body, delimiter, ncols)
    nrows = len(fields) // ncols
    want = columns or header
    out: Dict[str, np.ndarray] = {}
    for name in want:
        ci = header.index(name)
        vals = [fields[r * ncols + ci] for r in range(nrows)]
        out[name] = _typed(vals, schema.field(name).data_type if schema and name in schema else None)
    return out


def _parse_fields(body: bytes, delimiter: str, ncols: int) -> List[str]:
    """Every field of the body, row-major; a blank line is skipped."""
    out = []
    for row in csv.reader(io.StringIO(body.decode("utf-8")), delimiter=delimiter):
        if not row:
            continue
        if len(row) != ncols:
            raise ValueError(f"CSV row arity {len(row)} != header arity {ncols}: {row[:4]}...")
        out.extend(row)
    return out


def _typed(vals: List[str], dt: Optional[DataType]) -> np.ndarray:
    if dt is None:
        return np.asarray(vals, dtype=object)
    if dt.is_string_like:
        return np.asarray(vals, dtype=object)
    none_like = {"", "null", "NULL", "None"}
    if any(v in none_like for v in vals):
        return np.asarray([None if v in none_like else _scalar(v, dt) for v in vals], dtype=object)
    return np.asarray([_scalar(v, dt) for v in vals], dtype=dt.np_dtype)


def _scalar(v: str, dt: DataType):
    if dt in (DataType.INT, DataType.LONG, DataType.TIMESTAMP):
        return int(float(v)) if "." in v or "e" in v.lower() else int(v)
    if dt is DataType.BOOLEAN:
        return v.strip().lower() in ("1", "true", "t", "yes")
    return float(v)


class CsvRecordReader:
    """Row-oriented reader facade (stream-SPI/file ingestion input)."""

    def __init__(self, path: str, delimiter: str = ",", schema: Optional[Schema] = None):
        self.columns = read_csv_columns(path, delimiter=delimiter, schema=schema)
        self._n = len(next(iter(self.columns.values()))) if self.columns else 0

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        names = list(self.columns)
        for i in range(self._n):
            yield {n: self.columns[n][i] for n in names}


class JsonRecordReader:
    """JSON-lines reader (pinot-json input format analog)."""

    def __init__(self, path: str):
        self.rows: List[Dict[str, Any]] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    self.rows.append(json.loads(line))

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def columns(self, names: List[str]) -> Dict[str, np.ndarray]:
        return {n: np.asarray([r.get(n) for r in self.rows], dtype=object) for n in names}
