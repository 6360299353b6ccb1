"""Segment persistence of the port against the JAX package's.

Both packages write one on-disk format (segment/store.py: columns.bin with
64-byte aligned regions, metadata.json with dtype and shape per region,
formatVersion 1, the CRC32 of the data).  A segment either package writes
must load in the other with identical decoded columns, dictionaries, packed
words, null masks and index arrays (inverted bitmaps, compressed postings,
range prefix rows, bloom bits), and answer the same SQL with identical rows
(assert_rows_match: exact, with rtol=1e-12 on the cells of float averages
and float sums, which the packages add in different orders).  The rest
holds the port's store to the JAX package's own rules: a CRC check, short
and missing files, the format version, 0-row segments, the two kill-points
of a segment write, and schema evolution (ensure_columns).
"""
import json
import os

import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment import store as jax_store
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.segment.segment import ImmutableSegment as JaxSegment
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment import store as port_store
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.segment.segment import ImmutableSegment as PortSegment
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.utils import crashpoints

from test_torch_query import assert_rows_match, make_data, make_schema

SEEDS = (1, 2, 3)


def make_config(C, name="t"):
    """Every index both packages persist: dense inverted (string with and
    without nulls), range, bloom (on a dictionary column and a raw one),
    the sorted column and the time column."""
    return C.TableConfig(
        name,
        indexing=C.IndexingConfig(
            inverted_index_columns=["city", "tag"],
            range_index_columns=["year"],
            sorted_column="day",
            bloom_filter_columns=["city", "v"],
        ),
        segments=C.SegmentsConfig(time_column="day"),
    )


def _datas():
    datas = [make_data(seed) for seed in SEEDS]
    datas[2]["city"][:100] = "den"  # segment 2's city dictionary differs
    return datas


def assert_same_segment(a, b):
    """Two segments (either package) hold the same host state."""
    assert (a.name, a.table_name, a.num_docs) == (b.name, b.table_name, b.num_docs)
    assert a.schema.to_dict() == b.schema.to_dict()
    assert a.creation_time_ms == b.creation_time_ms
    assert a.time_range == b.time_range
    assert list(a.columns) == list(b.columns)
    for name, ca in a.columns.items():
        cb = b.columns[name]
        assert ca.stats.to_dict() == cb.stats.to_dict()
        assert (ca.dictionary is None) == (cb.dictionary is None)
        if ca.dictionary is not None:
            assert ca.dictionary.values.tolist() == cb.dictionary.values.tolist()
            np.testing.assert_array_equal(np.asarray(ca.codes), np.asarray(cb.codes))
            assert ca.code_bits == cb.code_bits
            if ca.packed is not None:
                np.testing.assert_array_equal(np.asarray(ca.packed), np.asarray(cb.packed))
        else:
            np.testing.assert_array_equal(np.asarray(ca.values), np.asarray(cb.values))
            assert np.asarray(ca.values).dtype == np.asarray(cb.values).dtype
        if ca.nulls is None:
            assert cb.nulls is None
        else:
            np.testing.assert_array_equal(ca.nulls, cb.nulls)
        dec_a, dec_b = ca.decoded(), cb.decoded()
        assert list(dec_a) == list(dec_b)
    assert {k: set(v) for k, v in a.indexes.items()} == {k: set(v) for k, v in b.indexes.items()}
    for kind, by_col in a.indexes.items():
        for col, ia in by_col.items():
            ib = b.indexes[kind][col]
            assert ia.meta() == ib.meta()
            ra, rb = dict(ia.to_regions("x")), dict(ib.to_regions("x"))
            assert list(ra) == list(rb)
            for k in ra:
                np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]))


# (sql, approx cells): both packages answer these; the bloom filter prunes
# the point lookups on the raw column v
CROSS_SQL = [
    ("SELECT COUNT(*) FROM t", ()),
    ("SELECT SUM(v), MIN(v), MAX(v), AVG(v) FROM t", (3,)),
    ("SELECT SUM(v), COUNT(*) FROM t WHERE year > 2010", ()),
    ("SELECT SUM(v) FROM t WHERE city = 'sf'", ()),
    ("SELECT COUNT(*) FROM t WHERE city IN ('sf', 'den', 'zzz')", ()),
    ("SELECT SUM(price), COUNT(price), AVG(price) FROM t", (0, 2)),
    ("SELECT COUNT(*) FROM t WHERE tag IS NULL", ()),
    ("SELECT COUNT(*) FROM t WHERE price IS NULL", ()),
    ("SELECT city, year, COUNT(*), AVG(v) FROM t GROUP BY city, year LIMIT 1000", (3,)),
    ("SELECT tag, COUNT(*), SUM(big) FROM t GROUP BY tag LIMIT 100", ()),
    ("SELECT year, MIN(price), MAX(price), SUM(price) FROM t WHERE year >= 2005 "
     "GROUP BY year ORDER BY year LIMIT 50", (3,)),
    ("SELECT COUNT(*), SUM(v) FROM t WHERE v = 123456", ()),
    ("SELECT COUNT(*) FROM t WHERE v = 17", ()),
    ("SELECT city, v FROM t WHERE day < 3 ORDER BY v, city LIMIT 20", ()),
    ("SELECT SUM(v) FILTER (WHERE city = 'sf'), COUNT(*) FROM t WHERE day BETWEEN 50 AND 200", ()),
]


def _engines(jax_segments, port_segments):
    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(make_schema(jax_schema), make_config(jax_config))
    pe.register_table(make_schema(port_schema), make_config(port_config))
    for s in jax_segments:
        je.add_segment("t", s)
    for s in port_segments:
        pe.add_segment("t", s)
    return je, pe


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """Segments the JAX builder wrote (output_dir=), and the port's loads."""
    root = tmp_path_factory.mktemp("jax_written")
    segs, loaded = [], []
    for i, d in enumerate(_datas()):
        path = str(root / f"t{i}")
        segs.append(jax_build(make_schema(jax_schema), dict(d), f"t{i}", table_config=make_config(jax_config),
                              output_dir=path))
        loaded.append(PortSegment.load(path, verify=True))
    return segs, loaded


@pytest.fixture(scope="module")
def port_written(tmp_path_factory):
    """Segments the port's builder wrote (output_dir=), and the JAX loads."""
    root = tmp_path_factory.mktemp("port_written")
    segs, loaded = [], []
    for i, d in enumerate(_datas()):
        path = str(root / f"t{i}")
        segs.append(port_build(make_schema(port_schema), dict(d), f"t{i}", table_config=make_config(port_config),
                               output_dir=path))
        loaded.append(JaxSegment.load(path, verify=True))
    return segs, loaded


def test_jax_written_segments_load_in_the_port(jax_written):
    segs, loaded = jax_written
    for s, l in zip(segs, loaded):
        assert set(s.indexes) == {"inverted", "range", "bloom"}
        assert l.source_dir is not None
        assert_same_segment(s, l)


def test_port_written_segments_load_in_jax(port_written):
    segs, loaded = port_written
    for s, l in zip(segs, loaded):
        assert set(s.indexes) == {"inverted", "range", "bloom"}
        assert_same_segment(s, l)


def test_both_builders_write_the_same_bytes(jax_written, port_written):
    """Same data, same format: the metadata (creation time aside, which each
    build stamps) and the data file agree byte for byte."""
    for js, ps in zip(jax_written[0], port_written[0]):
        mj, _ = jax_store.read_segment(js.source_dir)
        mp, _ = port_store.read_segment(ps.source_dir)
        assert mj.pop("creationTimeMs") > 0 and mp.pop("creationTimeMs") > 0
        assert mj == mp
        with open(os.path.join(js.source_dir, "columns.bin"), "rb") as f:
            bj = f.read()
        with open(os.path.join(ps.source_dir, "columns.bin"), "rb") as f:
            assert f.read() == bj


@pytest.mark.parametrize("sql,approx", CROSS_SQL, ids=[q[0][:60] for q in CROSS_SQL])
def test_cross_format_queries(jax_written, port_written, sql, approx):
    """JAX-written segments: the JAX engine over its in-memory segments and
    the port's over its loads; port-written: the reverse."""
    for jax_segs, port_segs in ((jax_written[0], jax_written[1]), (port_written[1], port_written[0])):
        je, pe = _engines(jax_segs, port_segs)
        want, got = je.query(sql), pe.query(sql)
        assert_rows_match(got.rows, want.rows, approx, ordered="ORDER BY" in sql)
        assert got.stats.num_segments_pruned == want.stats.num_segments_pruned


def test_bloom_prunes_point_lookups_on_raw_columns(jax_written):
    _, loaded = jax_written
    _, pe = _engines([], loaded)
    res = pe.query("SELECT COUNT(*) FROM t WHERE v = 123456")
    assert res.rows == [(0,)] and res.stats.num_segments_pruned == len(loaded)
    assert all(seg.indexes["bloom"]["v"].might_contain(int(seg.column("v").values[0])) for seg in loaded)


# -- the compressed inverted index (high-cardinality postings) ---------------
HIGH_CARD = 66_000  # past the dense bitmap index's 2^16 codes


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compressed_inverted_index_crosses(tmp_path, writer):
    rng = np.random.default_rng(9)
    n = 70_000
    data = {"k": rng.permutation(n) % HIGH_CARD, "m": rng.integers(0, 100, n)}

    def schema(S):
        return S.Schema("hc", [S.FieldSpec("k", S.DataType.INT),
                               S.FieldSpec("m", S.DataType.LONG, role=S.FieldRole.METRIC)])

    def config(C):
        return C.TableConfig("hc", indexing=C.IndexingConfig(inverted_index_columns=["k"]))

    path = str(tmp_path / "hc")
    if writer == "jax":
        built = jax_build(schema(jax_schema), dict(data), "hc", table_config=config(jax_config), output_dir=path)
        loaded = PortSegment.load(path, verify=True)
    else:
        built = port_build(schema(port_schema), dict(data), "hc", table_config=config(port_config), output_dir=path)
        loaded = JaxSegment.load(path, verify=True)
    a, b = built.indexes["inverted"]["k"], loaded.indexes["inverted"]["k"]
    assert a.meta() == b.meta() == {"kind": "cinverted", "numDocs": n}
    for codes in ([0], [5, 77, HIGH_CARD - 1], list(range(0, HIGH_CARD, 997))):
        np.testing.assert_array_equal(a.doc_bitmap(codes), b.doc_bitmap(codes))
    assert_same_segment(built, loaded)


# -- the store's own rules ----------------------------------------------------
def _small(n=500, seed=4, name="s"):
    d = make_data(seed, n)
    return port_build(make_schema(port_schema), d, name, table_config=make_config(port_config))


def test_round_trip(tmp_path):
    seg = _small()
    seg.save(str(tmp_path / "s"))
    assert seg.source_dir == str(tmp_path / "s")
    loaded = PortSegment.load(str(tmp_path / "s"), verify=True)
    assert_same_segment(seg, loaded)
    # the forward index and raw columns come back as zero-copy mmaps
    assert isinstance(loaded.column("v").values, np.memmap)


def _region(path, name):
    meta, _ = port_store.read_segment(path)
    (r,) = [r for r in meta["regions"] if r["name"] == name]
    return r


def test_verify_catches_a_flipped_byte(tmp_path):
    path = str(tmp_path / "s")
    _small().save(path)
    r = _region(path, "v.fwd")
    with open(os.path.join(path, "columns.bin"), "r+b") as f:
        f.seek(r["offset"] + 3)
        b = f.read(1)
        f.seek(r["offset"] + 3)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(port_store.SegmentCorruptError, match="CRC32"):
        PortSegment.load(path, verify=True)
    # both packages refuse the same file
    with pytest.raises(jax_store.SegmentCorruptError, match="CRC32"):
        JaxSegment.load(path, verify=True)
    PortSegment.load(path)  # unverified: loads (the caller chose not to check)


def test_verify_catches_a_short_data_file(tmp_path):
    path = str(tmp_path / "s")
    _small().save(path)
    data = os.path.join(path, "columns.bin")
    os.truncate(data, os.path.getsize(data) - 7)
    with pytest.raises(port_store.SegmentCorruptError, match="bytes, metadata commits"):
        PortSegment.load(path, verify=True)


@pytest.mark.parametrize("missing", ["columns.bin", "metadata.json"])
def test_verify_catches_a_missing_file(tmp_path, missing):
    path = str(tmp_path / "s")
    _small().save(path)
    os.remove(os.path.join(path, missing))
    with pytest.raises(port_store.SegmentCorruptError, match=f"missing {missing}"):
        PortSegment.load(path, verify=True)


def test_wrong_format_version_is_refused(tmp_path):
    path = str(tmp_path / "s")
    _small().save(path)
    meta_path = os.path.join(path, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["formatVersion"] = 2
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    for verify in (False, True):
        with pytest.raises(ValueError, match="unsupported segment format version 2"):
            PortSegment.load(path, verify=verify)


def test_zero_row_segment_loads(tmp_path):
    path = str(tmp_path / "empty")
    seg = _small(n=0)
    seg.save(path)
    loaded = PortSegment.load(path, verify=True)
    assert loaded.num_docs == 0 and list(loaded.columns) == list(seg.columns)
    assert JaxSegment.load(path, verify=True).num_docs == 0
    pe = PortEngine(device="cpu")
    pe.register_table(make_schema(port_schema), make_config(port_config))
    pe.add_segment("t", loaded)
    assert pe.query("SELECT COUNT(*) FROM t").rows == [(0,)]


@pytest.fixture
def _clean_points():
    crashpoints.reset()
    yield
    crashpoints.reset()


@pytest.mark.parametrize("point", ["segment.write.after_data_write", "segment.write.after_data_replace"])
def test_killed_write_leaves_the_old_segment_or_none(tmp_path, point, _clean_points):
    """A crash between the steps of a write: a fresh directory holds no
    segment; over a committed one, the old segment still loads (the crash
    came before the new data replaced the old) or verify refuses the pair
    (new data under the old metadata) — never a torn segment that loads."""
    old, new = _small(seed=4, name="old"), _small(seed=5, name="new")
    fresh = str(tmp_path / "fresh")
    crashpoints.arm(point)
    with pytest.raises(crashpoints.InjectedCrash):
        new.save(fresh)
    with pytest.raises(port_store.SegmentCorruptError, match="missing metadata.json"):
        PortSegment.load(fresh, verify=True)

    path = str(tmp_path / "seg")
    old.save(path)
    crashpoints.arm(point)
    with pytest.raises(crashpoints.InjectedCrash):
        new.save(path)
    if point == "segment.write.after_data_write":
        assert_same_segment(old, PortSegment.load(path, verify=True))
    else:
        # a short file or a CRC mismatch, as the new data's size falls
        with pytest.raises(port_store.SegmentCorruptError):
            PortSegment.load(path, verify=True)
    # the point disarmed on firing: the retried write commits
    new.save(path)
    assert_same_segment(new, PortSegment.load(path, verify=True))


# -- schema evolution ---------------------------------------------------------
def _evolved(S):
    """The table schema after two nullable columns were added."""
    base = make_schema(S)
    return S.Schema("t", list(base.fields) + [
        S.FieldSpec("added_n", S.DataType.INT, role=S.FieldRole.METRIC, nullable=True),
        S.FieldSpec("added_s", S.DataType.STRING, nullable=True),
    ])


EVOLVED_SQL = [
    ("SELECT COUNT(added_n), SUM(added_n), COUNT(*) FROM t", ()),
    ("SELECT COUNT(*) FROM t WHERE added_n IS NULL", ()),
    ("SELECT COUNT(*) FROM t WHERE added_s IS NOT NULL", ()),
    ("SELECT added_s, COUNT(*) FROM t GROUP BY added_s LIMIT 10", ()),
    ("SELECT * FROM t ORDER BY v, day LIMIT 7", ()),
]


def test_ensure_columns_matches_jax():
    d = make_data(6, 300)
    js = jax_build(make_schema(jax_schema), dict(d), "old", table_config=make_config(jax_config))
    ps = port_build(make_schema(port_schema), dict(d), "old", table_config=make_config(port_config))
    js.ensure_columns(_evolved(jax_schema), ["added_n", "added_s", "v", "nope"])
    ps.ensure_columns(_evolved(port_schema), ["added_n", "added_s", "v", "nope"])
    assert ps.column_names == js.column_names
    for name in ("added_n", "added_s"):
        cj, cp = js.column(name), ps.column(name)
        assert cp.stats.to_dict() == cj.stats.to_dict()
        assert cp.nulls.all() and cj.nulls.all()
        assert list(cp.decoded()) == list(cj.decoded())


@pytest.mark.parametrize("sql,approx", EVOLVED_SQL, ids=[q[0][:50] for q in EVOLVED_SQL])
def test_schema_evolution_queries_match_jax(sql, approx):
    """Segments built before the columns were added, under the evolved table
    schema: the added columns read as NULL, SELECT * covers them."""
    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(_evolved(jax_schema), make_config(jax_config))
    pe.register_table(_evolved(port_schema), make_config(port_config))
    for i, d in enumerate(_datas()):
        je.add_segment("t", jax_build(make_schema(jax_schema), dict(d), f"t{i}", table_config=make_config(jax_config)))
        pe.add_segment("t", port_build(make_schema(port_schema), dict(d), f"t{i}",
                                       table_config=make_config(port_config)))
    want, got = je.query(sql), pe.query(sql)
    assert got.columns == want.columns
    assert_rows_match(got.rows, want.rows, approx, ordered="ORDER BY" in sql)
