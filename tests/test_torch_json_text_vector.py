"""The port's JSON, text and vector indexes against the JAX package's.

The data and table config of tests/test_json_text_vector.py (a JSON column
with a JSON index, a STRING column with a text index, an 8-float embedding
column with a vector index, a LONG metric) go through both packages'
builders.  The built indexes must be equal (text token tables, flattened
JSON paths, the normalized vector matrix), and so must the answers of every
predicate of the JAX test file — JSON_MATCH, TEXT_MATCH (terms, OR/NOT,
phrases, prefixes, regex, wildcards, fuzzy), the lazy text index without a
config, VECTOR_SIMILARITY alone and with a metadata filter — saved and
loaded on both sides, and each also against a per-value Python golden.
A segment the JAX package saved with MV columns and all four index kinds
(JSON, text, vector, star-tree) loads into the port and answers the same.

Tolerance: exact; VECTOR_SIMILARITY's selected rows equal a float64 numpy
golden except rows whose score lies within 1e-5 of the k-th score.
"""
import json

import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.indexes.vector import VectorIndex as JaxVectorIndex
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.segment.segment import ImmutableSegment as JaxSegment
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.indexes.jsonidx import flatten_json
from pinot_tpu_torch.indexes.text import _edit_within
from pinot_tpu_torch.indexes.vector import VectorIndex, similarity_mask
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.segment.segment import ImmutableSegment as PortSegment
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema

from test_torch_query import assert_rows_match

N = 3000
WORDS = ["quick", "brown", "fox", "lazy", "dog", "jumps", "search", "engine", "analytics"]


def make_schema(S, mv=False):
    fields = [
        S.FieldSpec("meta", S.DataType.JSON),
        S.FieldSpec("body", S.DataType.STRING),
        S.FieldSpec("embedding", S.DataType.FLOAT, single_value=False),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
    ]
    if mv:
        fields += [S.FieldSpec("tags", S.DataType.STRING, single_value=False),
                   S.FieldSpec("yr", S.DataType.INT)]
    return S.Schema("docs", fields)


def make_config(C, tree=False):
    st = [{"dimensionsSplitOrder": ["yr"], "functionColumnPairs": ["COUNT__*", "SUM__v"]}] if tree else []
    return C.TableConfig(
        name="docs",
        indexing=C.IndexingConfig(
            json_index_columns=["meta"], text_index_columns=["body"], vector_index_columns=["embedding"],
            star_tree_index_configs=st,
        ),
    )


def make_data(seed=47, n=N, mv=False):
    rng = np.random.default_rng(seed)
    metas, bodies, embs = [], [], []
    for _ in range(n):
        metas.append(json.dumps({
            "user": {"id": int(rng.integers(0, 50)), "tier": ["free", "pro", "ent"][int(rng.integers(0, 3))]},
            "events": [{"kind": "click"}] * int(rng.integers(0, 3)),
            "score": float(np.round(rng.random() * 10, 2)),
        }))
        bodies.append(" ".join(rng.choice(WORDS, size=6)))
        embs.append(list(rng.normal(size=8).astype(float)))
    out = {"meta": metas, "body": bodies, "embedding": embs, "v": rng.integers(0, 100, n)}
    if mv:
        out["tags"] = [list(rng.choice(WORDS, size=int(rng.integers(0, 3)), replace=False)) for _ in range(n)]
        out["yr"] = rng.integers(2000, 2004, n).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """(jax segment, port segment), each saved and loaded by its package."""
    out = []
    for build, load, C, S, tag in ((jax_build, JaxSegment.load, jax_config, jax_schema, "jax"),
                                   (port_build, PortSegment.load, port_config, port_schema, "port")):
        path = str(tmp_path_factory.mktemp(f"jtv_{tag}") / "s0")
        build(make_schema(S), dict(data), "s0", table_config=make_config(C)).save(path)
        out.append(load(path))
    return tuple(out)


@pytest.fixture(scope="module")
def engines(built):
    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(make_schema(jax_schema), make_config(jax_config))
    pe.register_table(make_schema(port_schema), make_config(port_config))
    je.add_segment("docs", built[0])
    pe.add_segment("docs", built[1])
    return je, pe


def _metas(data):
    return [json.loads(m) for m in data["meta"]]


def test_built_indexes_match_jax(data):
    j = jax_build(make_schema(jax_schema), dict(data), "s0", table_config=make_config(jax_config))
    p = port_build(make_schema(port_schema), dict(data), "s0", table_config=make_config(port_config))
    jt, pt = j.indexes["text"]["body"], p.indexes["text"]["body"]
    assert sorted(pt.tokens) == sorted(jt.tokens)
    for tok, tbl in jt.tokens.items():
        np.testing.assert_array_equal(pt.tokens[tok], tbl)
    assert p.indexes["json"]["meta"].flattened == j.indexes["json"]["meta"].flattened
    jv, pv = j.indexes["vector"]["embedding"], p.indexes["vector"]["embedding"]
    assert pv.dim == jv.dim == 8
    np.testing.assert_array_equal(pv.matrix, jv.matrix)
    np.testing.assert_array_equal(p.column("embedding").values, j.column("embedding").values)
    np.testing.assert_array_equal(p.column("embedding").mv_lengths, j.column("embedding").mv_lengths)
    assert p.column("embedding").stats.to_dict() == j.column("embedding").stats.to_dict()


def test_helpers_match_jax():
    from pinot_tpu.indexes.jsonidx import flatten_json as jax_flatten
    from pinot_tpu.indexes.text import _edit_within as jax_edit

    doc = {"a": {"b": 1}, "c": [{"d": "x"}, {"d": "y"}], "e": 2.5}
    assert flatten_json(doc) == jax_flatten(doc)
    assert flatten_json(doc)["$.c[*].d"] == ["x", "y"]
    for a, b, k in (("kitten", "sitting", 3), ("kitten", "sitting", 2), ("abc", "abd", 0), ("a", "abcd", 2)):
        assert _edit_within(a, b, k) == jax_edit(a, b, k)
    rng = np.random.default_rng(1)
    m = rng.normal(size=(40, 5)).astype(np.float32)
    lengths = np.full(40, 5, np.int32)
    lengths[3] = 2
    np.testing.assert_array_equal(VectorIndex.build(m, lengths).matrix, JaxVectorIndex.build(m, lengths).matrix)


def _toks(b):
    return set(b.split())


# (sql, python golden over (metas, bodies, v), index use)
SQL_SET = [
    ("SELECT COUNT(*) FROM docs WHERE JSON_MATCH(meta, '\"$.user.tier\" = ''pro''')",
     lambda m, b, v: m["user"]["tier"] == "pro", ("meta", "json")),
    ("SELECT COUNT(*) FROM docs WHERE JSON_MATCH(meta, '\"$.score\" > 5 AND \"$.user.tier\" != ''free''')",
     lambda m, b, v: m["score"] > 5 and m["user"]["tier"] != "free", ("meta", "json")),
    ("SELECT COUNT(*) FROM docs WHERE JSON_MATCH(meta, '\"$.events[*].kind\" IS NOT NULL')",
     lambda m, b, v: bool(m["events"]), ("meta", "json")),
    ("SELECT COUNT(*) FROM docs WHERE JSON_MATCH(meta, '\"$.user.id\" < 10 OR NOT \"$.user.tier\" = ''ent''') "
     "AND v > 20", lambda m, b, v: (m["user"]["id"] < 10 or m["user"]["tier"] != "ent") and v > 20, ("meta", "json")),
    ("SELECT COUNT(*) FROM docs WHERE JSON_EXTRACT_SCALAR(meta, '$.user.id', 'LONG') < 10",
     lambda m, b, v: m["user"]["id"] < 10, None),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'quick fox')",
     lambda m, b, v: {"quick", "fox"} <= _toks(b), ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'search engine OR analytics NOT lazy')",
     lambda m, b, v: {"search", "engine"} <= _toks(b) or ("analytics" in _toks(b) and "lazy" not in _toks(b)),
     ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, '\"quick brown\"')", lambda m, b, v: "quick brown" in b,
     ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'jump*')",
     lambda m, b, v: any(t.startswith("jump") for t in b.split()), ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, '/(fox|dog)/')",
     lambda m, b, v: bool({"fox", "dog"} & _toks(b)), ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'an*tics')", lambda m, b, v: "analytics" in _toks(b),
     ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'f?x')", lambda m, b, v: "fox" in _toks(b), ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'quickk~1')", lambda m, b, v: "quick" in _toks(b),
     ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'analytcs~')", lambda m, b, v: "analytics" in _toks(b),
     ("body", "text")),
    ("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'sarch~0')", lambda m, b, v: False, ("body", "text")),
]


@pytest.mark.parametrize("sql,golden,use", SQL_SET, ids=[q[0][34:100] for q in SQL_SET])
def test_predicates_match_jax_and_golden(engines, data, sql, golden, use):
    je, pe = engines
    got, want = pe.query(sql), je.query(sql)
    assert_rows_match(got.rows, want.rows)
    assert got.stats.filter_index_uses == want.stats.filter_index_uses
    assert got.rows[0][0] == sum(1 for m, b, v in zip(_metas(data), data["body"], data["v"]) if golden(m, b, v))
    if use is not None:
        assert use in got.stats.filter_index_uses


def test_json_extract_groupby_matches_jax(engines):
    je, pe = engines
    sql = ("SELECT JSON_EXTRACT_SCALAR(meta, '$.user.tier', 'STRING'), COUNT(*) FROM docs "
           "GROUP BY JSON_EXTRACT_SCALAR(meta, '$.user.tier', 'STRING') "
           "ORDER BY JSON_EXTRACT_SCALAR(meta, '$.user.tier', 'STRING')")
    assert_rows_match(pe.query(sql).rows, je.query(sql).rows, ordered=True)


def test_lazy_text_index_without_config(data):
    """TEXT_MATCH without a configured index tokenizes the dictionary
    lazily, caches the index on the segment, and counts no index use."""
    cfg = port_config.TableConfig(name="docs", indexing=port_config.IndexingConfig(vector_index_columns=["embedding"]))
    seg = port_build(make_schema(port_schema), dict(data), "s0", table_config=cfg)
    pe = PortEngine(device="cpu")
    pe.register_table(make_schema(port_schema))
    pe.add_segment("docs", seg)
    res = pe.query("SELECT COUNT(*) FROM docs WHERE TEXT_MATCH(body, 'dog')")
    assert res.rows[0][0] == sum(1 for b in data["body"] if "dog" in _toks(b))
    assert res.stats.filter_index_uses == ()
    assert "body" in seg.indexes["text"]  # cached for the next query
    res2 = pe.query("SELECT COUNT(*) FROM docs WHERE JSON_MATCH(meta, '\"$.user.tier\" = ''free''')")
    assert res2.rows[0][0] == sum(1 for m in _metas(data) if m["user"]["tier"] == "free")


def _vector_golden(data, q, k):
    """(rows surely selected, rows surely not) from float64 cosine scores:
    the rows within 1e-5 of the k-th score may go either way."""
    m = np.asarray(data["embedding"], dtype=np.float32).astype(np.float64)
    q = np.asarray(q, dtype=np.float32).astype(np.float64)
    scores = (m / np.linalg.norm(m, axis=1, keepdims=True)) @ (q / np.linalg.norm(q))
    kth = np.sort(scores)[::-1][k - 1]
    return scores > kth + 1e-5, scores < kth - 1e-5


@pytest.mark.parametrize("k", [1, 5, 50])
def test_vector_top_k_matches_jax_and_golden(engines, data, k):
    je, pe = engines
    q = np.asarray(data["embedding"][17], dtype=np.float32)
    qs = json.dumps([float(x) for x in q])
    sql = f"SELECT v FROM docs WHERE VECTOR_SIMILARITY(embedding, '{qs}', {k}) LIMIT 1000"
    got, want = pe.query(sql), je.query(sql)
    assert_rows_match(got.rows, want.rows)
    assert ("embedding", "vector") in got.stats.filter_index_uses
    # the selected row set, through the predicate itself
    seg = pe.table("docs").segments[0]
    vidx = seg.indexes["vector"]["embedding"]
    import torch

    mask = similarity_mask(torch.from_numpy(np.array(seg.column("embedding").values)),
                           torch.from_numpy(vidx.normalize_query(q)), vidx.dim, k).numpy()
    sure_in, sure_out = _vector_golden(data, q, k)
    assert mask[sure_in].all() and not mask[sure_out].any()
    assert mask.sum() >= k


def test_vector_with_metadata_filter(engines):
    je, pe = engines
    q = json.dumps([1.0] * 8)
    sql = f"SELECT COUNT(*), SUM(v) FROM docs WHERE VECTOR_SIMILARITY(embedding, '{q}', 50) AND v > 50"
    got = pe.query(sql)
    assert_rows_match(got.rows, je.query(sql).rows)
    assert 0 < got.rows[0][0] <= 50


def test_vector_errors_match_jax(engines):
    je, pe = engines
    for sql in ("SELECT COUNT(*) FROM docs WHERE VECTOR_SIMILARITY(embedding, '[1.0, 2.0]', 5)",
                "SELECT COUNT(*) FROM docs WHERE VECTOR_SIMILARITY(body, '[1.0]', 5)"):
        for eng in (je, pe):
            with pytest.raises(ValueError):
                eng.query(sql)


def test_jax_saved_segment_with_every_index_kind_loads(tmp_path):
    """MV columns and the JSON, text, vector and star-tree indexes, saved by
    the JAX package, load into the port verified and answer the same."""
    data = make_data(seed=5, n=1200, mv=True)
    path = str(tmp_path / "all")
    jax_build(make_schema(jax_schema, mv=True), dict(data), "s0",
              table_config=make_config(jax_config, tree=True)).save(path)
    seg = PortSegment.load(path, verify=True)
    assert {"json", "text", "vector", "startree"} <= set(seg.indexes)
    assert seg.column("tags").is_multi_value and seg.column("embedding").is_multi_value
    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(make_schema(jax_schema, mv=True))
    pe.register_table(make_schema(port_schema, mv=True))
    je.add_segment("docs", JaxSegment.load(path))
    pe.add_segment("docs", seg)
    q = json.dumps([0.5] * 8)
    for sql in (
        "SELECT tags, COUNT(*), SUM(v) FROM docs WHERE TEXT_MATCH(body, 'fox OR dog') GROUP BY tags LIMIT 100",
        "SELECT COUNT(*) FROM docs WHERE JSON_MATCH(meta, '\"$.user.tier\" = ''ent''') AND tags = 'lazy'",
        f"SELECT yr, COUNT(*), SUM(v) FROM docs WHERE VECTOR_SIMILARITY(embedding, '{q}', 100) GROUP BY yr",
        "SELECT yr, SUM(v), COUNT(*) FROM docs GROUP BY yr",
    ):
        got, want = pe.query(sql), je.query(sql)
        assert_rows_match(got.rows, want.rows)
        assert got.stats.filter_index_uses == want.stats.filter_index_uses
    assert "startree" in {k for _, k in pe.query("SELECT yr, SUM(v) FROM docs GROUP BY yr").stats.filter_index_uses}
