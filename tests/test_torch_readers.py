"""The port's CSV and JSON-lines readers against the JAX package's.

Mirrors tests/test_native.py's CSV cases (quoted fields with delimiters,
doubled quotes and newlines, typed columns from a schema, a CSV into a
segment and a query, a ragged row) and adds nulls, a delimiter, a column
subset and the row readers.  The same file goes through both packages'
readers: string columns must be equal, typed columns equal in dtype and
value (integers exactly, floats to rtol 1e-9), and the segment built from
each answers the same query exactly.  The JAX package may parse through
its native library (native/csv.cc) where it builds; the port has only the
Python parse, which gives the same fields.
"""
import json

import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu import ingest as jax_ingest
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch import ingest as port_ingest
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import schema as port_schema

# float columns of the two readers agree to this relative tolerance
RTOL = 1e-9


def assert_same_columns(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0.0)
        else:
            assert g.tolist() == w.tolist(), name


QUOTED = 'name,city,v\n"Smith, John",sf,1\nJane,"ny""c",2\n"multi\nline",la,3\n'


def test_csv_reader_with_quotes(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text(QUOTED, encoding="utf-8")
    got = port_ingest.read_csv_columns(str(p))
    assert list(got["name"]) == ["Smith, John", "Jane", "multi\nline"]
    assert list(got["city"]) == ["sf", 'ny"c', "la"]
    assert list(got["v"]) == ["1", "2", "3"]
    assert_same_columns(got, jax_ingest.read_csv_columns(str(p)))


def _typed_schema(S):
    return S.Schema("t", [
        S.FieldSpec("name", S.DataType.STRING),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
        S.FieldSpec("p", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
        S.FieldSpec("ok", S.DataType.BOOLEAN),
    ])


def test_csv_typed_with_schema(tmp_path):
    p = tmp_path / "t.csv"
    rng = np.random.default_rng(4)
    rows = [f"r{i},{i * 3},{float(rng.normal()) * 1e3!r},{['true', '0', 'yes', 'F'][i % 4]}" for i in range(1000)]
    p.write_text("name,v,p,ok\n" + "\n".join(rows) + "\n", encoding="utf-8")
    got = port_ingest.read_csv_columns(str(p), schema=_typed_schema(port_schema))
    assert got["v"].dtype == np.int64 and got["v"][999] == 2997
    assert_same_columns(got, jax_ingest.read_csv_columns(str(p), schema=_typed_schema(jax_schema)))


def test_csv_nulls_subset_and_delimiter(tmp_path):
    p = tmp_path / "t.tsv"
    p.write_text("name\tv\tp\tok\nа\t1\t\t1\nb\tnull\t2.5\t0\nc\t3e2\t1.25\ttrue\n", encoding="utf-8")
    for cols in (None, ["p", "name"]):
        got = port_ingest.read_csv_columns(str(p), columns=cols, delimiter="\t", schema=_typed_schema(port_schema))
        want = jax_ingest.read_csv_columns(str(p), columns=cols, delimiter="\t", schema=_typed_schema(jax_schema))
        assert_same_columns(got, want)
    assert got["p"].tolist() == [None, 2.5, 1.25] and list(got) == ["p", "name"]


def test_csv_into_segment(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("city,v\n" + "\n".join(f"c{i % 7},{i}" for i in range(5000)), encoding="utf-8")
    out = {}
    for name, S, read, build, eng in (
        ("jax", jax_schema, jax_ingest.read_csv_columns, jax_build, JaxEngine()),
        ("port", port_schema, port_ingest.read_csv_columns, port_build, PortEngine(device="cpu")),
    ):
        schema = S.Schema("t", [S.FieldSpec("city", S.DataType.STRING),
                                S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC)])
        eng.register_table(schema)
        eng.add_segment("t", build(schema, read(str(p), schema=schema), "s0"))
        out[name] = (eng.query("SELECT COUNT(*), SUM(v) FROM t").rows,
                     eng.query("SELECT city, COUNT(*), SUM(v) FROM t GROUP BY city ORDER BY city").rows)
    assert out["port"][0] == [(5000, float(sum(range(5000))))]
    assert out["port"] == out["jax"]


def test_ragged_row_raises(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("a,b\n1,2\n3\n", encoding="utf-8")
    for read in (port_ingest.read_csv_columns, jax_ingest.read_csv_columns):
        with pytest.raises(ValueError, match="arity"):
            read(str(p))
    (tmp_path / "none.csv").write_bytes(b"")
    for read in (port_ingest.read_csv_columns, jax_ingest.read_csv_columns):
        with pytest.raises(ValueError, match="no header"):
            read(str(tmp_path / "none.csv"))


def test_csv_record_reader(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text(QUOTED, encoding="utf-8")
    got, want = port_ingest.CsvRecordReader(str(p)), jax_ingest.CsvRecordReader(str(p))
    assert len(got) == len(want) == 3
    assert [dict(r) for r in got] == [dict(r) for r in want]


def test_json_record_reader(tmp_path):
    p = tmp_path / "t.jsonl"
    rows = [{"a": i, "b": f"s{i}", "c": [i, i + 1]} for i in range(5)] + [{"a": 9}]
    p.write_text("\n".join(json.dumps(r) for r in rows[:3]) + "\n\n" + "\n".join(json.dumps(r) for r in rows[3:]) + "\n",
                 encoding="utf-8")
    got, want = port_ingest.JsonRecordReader(str(p)), jax_ingest.JsonRecordReader(str(p))
    assert len(got) == len(want) == 6 and list(got) == list(want) == rows
    gc, wc = got.columns(["a", "b"]), want.columns(["a", "b"])
    assert {k: v.tolist() for k, v in gc.items()} == {k: v.tolist() for k, v in wc.items()}
    assert gc["b"].tolist()[-1] is None
