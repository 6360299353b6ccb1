"""The port's segment layer against the JAX package's.

The port's builder must reproduce the JAX builder's arrays exactly on the
same data: dictionaries, codes, bit-packed words, null masks, stats, range
prefix bitmaps and inverted bitmaps — with nulls, a sorted column, and
dictionary cardinalities on the 16/17/256/257 lane boundaries.
A JAX-built segment carried across (saved by the JAX package, loaded by the
port: the packages share one on-disk format) must equal the port's own build
and answer queries as the JAX segment does.  The torch unpackers must equal
the JAX ones exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.ops import segmented as jax_segmented
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment import packing as jax_packing
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.ops import segmented
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment import packing
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.segment.segment import ImmutableSegment as PortSegment
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema

N = 2000


def _data(seed):
    rng = np.random.default_rng(seed)
    c17 = rng.integers(0, 17, N)
    return {
        "c16": rng.integers(0, 16, N).astype(np.int32),
        "c17": np.asarray([None if x == 0 else f"s{x}" for x in c17], dtype=object),
        "c256": rng.integers(0, 256, N).astype(np.int32),
        "c257": rng.integers(0, 257, N).astype(np.int32),
        "sorted_day": rng.integers(0, 366, N).astype(np.int32),
        "m_int": rng.integers(-50, 1000, N),
        "m_big": rng.integers(-(1 << 40), 1 << 40, N),
        "m_nullable": np.where(rng.random(N) < 0.1, np.nan, rng.integers(0, 99, N).astype(np.float64)),
        "price": np.where(rng.random(N) < 0.2, np.nan, rng.random(N)),
    }


def _schema(S):
    D, R = S.DataType, S.FieldRole
    return S.Schema(
        "seg",
        [
            S.FieldSpec("c16", D.INT),
            S.FieldSpec("c17", D.STRING, nullable=True),
            S.FieldSpec("c256", D.INT),
            S.FieldSpec("c257", D.INT),
            S.FieldSpec("sorted_day", D.INT),
            S.FieldSpec("m_int", D.LONG, role=R.METRIC),
            S.FieldSpec("m_big", D.LONG, role=R.METRIC),
            S.FieldSpec("m_nullable", D.LONG, role=R.METRIC, nullable=True),
            S.FieldSpec("price", D.DOUBLE, role=R.METRIC, nullable=True),
        ],
    )


def _config(C):
    return C.TableConfig(
        "seg",
        indexing=C.IndexingConfig(
            inverted_index_columns=["c17", "c256"],
            range_index_columns=["c16", "c257"],
            sorted_column="sorted_day",
        ),
    )


def carried(jseg, tmp_path_factory):
    """A JAX-built segment carried into the port: saved by the JAX package,
    loaded (verified) by the port."""
    path = str(tmp_path_factory.mktemp("carried") / jseg.name)
    jseg.save(path)
    return PortSegment.load(path, verify=True)


@pytest.fixture(scope="module")
def built():
    data = _data(5)
    js, ts = _schema(jax_schema), _schema(port_schema)
    jseg = jax_build(js, dict(data), "s0", table_config=_config(jax_config))
    tseg = port_build(ts, dict(data), "s0", table_config=_config(port_config))
    return jseg, tseg


def _assert_same_segment(a, b):
    assert a.num_docs == b.num_docs
    assert list(a.columns) == list(b.columns)
    for name, ca in a.columns.items():
        cb = b.columns[name]
        assert (ca.dictionary is None) == (cb.dictionary is None), name
        if ca.dictionary is not None:
            np.testing.assert_array_equal(ca.dictionary.values, cb.dictionary.values)
            assert ca.dictionary.fingerprint() == cb.dictionary.fingerprint()
            assert ca.codes.dtype == cb.codes.dtype, name
            np.testing.assert_array_equal(ca.codes, cb.codes)
            assert ca.code_bits == cb.code_bits, name
            if ca.packed is not None:
                assert cb.packed.dtype == np.uint32
                np.testing.assert_array_equal(ca.packed, cb.packed)
        else:
            assert ca.values.dtype == cb.values.dtype, name
            np.testing.assert_array_equal(ca.values, cb.values)
        if ca.nulls is None:
            assert cb.nulls is None, name
        else:
            np.testing.assert_array_equal(ca.nulls, cb.nulls)
        assert ca.stats.to_dict() == cb.stats.to_dict(), name
    assert {k: sorted(v) for k, v in a.indexes.items()} == {k: sorted(v) for k, v in b.indexes.items()}
    for name, idx in a.indexes.get("range", {}).items():
        np.testing.assert_array_equal(idx.prefix, b.indexes["range"][name].prefix)
    for name, idx in a.indexes.get("inverted", {}).items():
        np.testing.assert_array_equal(idx.bitmaps, b.indexes["inverted"][name].bitmaps)


def test_builder_matches_jax_builder(built):
    jseg, tseg = built
    assert {c: tseg.column(c).code_bits for c in ("c16", "c17", "c256", "c257")} == {
        "c16": 4, "c17": 8, "c256": 8, "c257": 16,
    }
    _assert_same_segment(jseg, tseg)


def test_segment_from_numpy_equals_port_build(built, tmp_path_factory):
    jseg, tseg = built
    _assert_same_segment(tseg, carried(jseg, tmp_path_factory))


def test_carried_segment_answers_as_jax(built, tmp_path_factory):
    jseg, _ = built
    port_segment = carried(jseg, tmp_path_factory)
    jax_engine, port_engine = JaxEngine(), PortEngine(device="cpu")
    jax_engine.register_table(_schema(jax_schema), _config(jax_config))
    port_engine.register_table(_schema(port_schema), _config(port_config))
    jax_engine.add_segment("seg", jseg)
    port_engine.add_segment("seg", port_segment)
    for sql in (
        "SELECT c257, COUNT(*), SUM(m_big) FROM seg WHERE c16 < 9 GROUP BY c257 LIMIT 300",
        "SELECT c17, SUM(m_nullable), COUNT(m_nullable) FROM seg WHERE c256 IN (1, 2, 3, 200) "
        "GROUP BY c17 LIMIT 100",
        "SELECT SUM(m_int), MIN(m_int), MAX(m_big) FROM seg WHERE sorted_day BETWEEN 10 AND 90",
    ):
        got, want = port_engine.query(sql), jax_engine.query(sql)
        assert sorted(got.rows, key=repr) == sorted(want.rows, key=repr), sql
        assert got.stats.filter_index_uses == want.stats.filter_index_uses


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 31, 1000, 4096])
def test_unpack_codes_torch_matches_jnp(rng, bits, n):
    codes = rng.integers(0, 1 << bits, n).astype(np.uint32)
    words = packing.pack_codes(codes, bits)
    np.testing.assert_array_equal(words, jax_packing.pack_codes(codes, bits))
    np.testing.assert_array_equal(packing.unpack_codes(words, bits, n), codes)
    got = packing.unpack_codes_torch(torch.from_numpy(words.view(np.int32)), bits, n)
    want = jax_packing.unpack_codes_jnp(jnp.asarray(words), bits, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [32, 1000 * 32])
def test_unpack_bitmap_words_matches_jax(rng, n):
    words = rng.integers(0, 2**32, n // 32, dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF  # bit 31 set: the int32 view is negative
    got = segmented.unpack_bitmap_words(torch.from_numpy(words.view(np.int32)), n)
    want = jax_segmented.unpack_bitmap_words(jnp.asarray(words), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_to_device_cpu_entries(built):
    _, tseg = built
    cols = tseg.to_device("cpu", columns=["c257", "c256", "m_big", "price"], packed_codes=True)
    assert set(cols["c257"]) == {"codes_packed", "dict"}
    assert cols["c257"]["codes_packed"].dtype == torch.int32
    assert set(cols["c256"]) == {"codes_packed", "dict"}
    assert cols["m_big"]["values"].dtype == torch.int64
    assert cols["price"]["nulls"].dtype == torch.bool
    unpacked = tseg.to_device("cpu", columns=["c257"])["c257"]["codes"]
    assert unpacked.dtype == torch.int32  # uint16 codes ship as int32
    np.testing.assert_array_equal(unpacked.numpy(), tseg.column("c257").codes)


def test_posting_list_index_matches_dense(rng):
    """The posting-list inverted index (cardinality past 2^16) answers
    doc_bitmap exactly as the dense one does."""
    from pinot_tpu_torch.indexes.inverted import CompressedInvertedIndex, InvertedIndex

    n, card = 5000, 300
    codes = rng.integers(0, card, n).astype(np.int32)
    dense = InvertedIndex.build(codes, card, n)
    postings = CompressedInvertedIndex.build(codes, card, n)
    for ids in ([0], [7, 299], list(range(0, 300, 3)), []):
        np.testing.assert_array_equal(postings.doc_bitmap(ids), dense.doc_bitmap(ids))


def test_builder_refuses_multi_value_columns():
    """Multi-value columns build (no longer refused) and decode as the JAX
    builder's: codes, lengths, dictionary and per-row tuples (None = [])."""
    rows = [["a"], ["b", "c"], [], None, ["c", "a", "c"]]
    schemas = [S.Schema("mv", [S.FieldSpec("tags", S.DataType.STRING, single_value=False)])
               for S in (port_schema, jax_schema)]
    got = port_build(schemas[0], {"tags": rows}, "x").column("tags")
    want = jax_build(schemas[1], {"tags": rows}, "x").column("tags")
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.mv_lengths, want.mv_lengths)
    np.testing.assert_array_equal(got.dictionary.values, want.dictionary.values)
    assert list(got.decoded()) == list(want.decoded()) == [("a",), ("b", "c"), (), (), ("c", "a", "c")]
