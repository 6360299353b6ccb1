"""The port's multi-value columns against the JAX package's.

The data of tests/test_multivalue.py (a STRING MV column of 0-3 tags, a LONG
MV column of 0-3 scores, a STRING city and a LONG metric), in two segments,
goes through both packages' builders; the built structures must be equal
(code matrices, lengths, dictionaries, stats), and so must the answers of
every query of the JAX test file — ANY-semantics EQ / IN / NOT IN / range
filters, COUNTMV / SUMMV / MINMV / MAXMV / AVGMV / DISTINCTCOUNTMV, the MV
group-by explode (dense and sparse), ARRAYLENGTH, UNNEST — on the segment
engine and, for everything but the explode (refused by both), on the
distributed engine.  A segment the JAX package saved loads into the port.
The explode's fused-scan input (the exploded int32 key, row x length mask,
broadcast values) goes through the port's plain fused scan and the JAX
package's Pallas kernel in interpret mode and XLA path.

Tolerance: exact (rows compare by value and Python type; tables bit for
bit), except AVGMV, which both packages divide alike but compare at
rtol=1e-12.
"""
from collections import Counter

import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from pinot_tpu import ops as jax_ops
from pinot_tpu.ops import pallas_scan, segmented as jax_segmented
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.segment.segment import ImmutableSegment as JaxSegment
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.ops import fused_scan
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import RaggedColumn
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.segment.segment import ImmutableSegment as PortSegment
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import parse_query as port_parse

from test_torch_query import assert_rows_match, spy_kernel_calls

N = 2500
TAGS = ["red", "green", "blue", "gold", "gray"]


def make_schema(S):
    return S.Schema(
        "mv",
        [
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("tags", S.DataType.STRING, single_value=False),
            S.FieldSpec("scores", S.DataType.LONG, single_value=False),
            S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
        ],
    )


def make_data(seed, n=N):
    rng = np.random.default_rng(seed)
    tags, scores = [], []
    for _ in range(n):
        k = int(rng.integers(0, 4))  # 0..3 elements (empty rows included)
        tags.append(list(rng.choice(TAGS, size=k, replace=False)))
        scores.append(list(rng.integers(0, 50, size=k)))
    return {
        "city": rng.choice(["sf", "nyc", "chi"], n).astype(object),
        "tags": tags,
        "scores": scores,
        "v": rng.integers(0, 100, n),
    }


@pytest.fixture(scope="module")
def datas():
    return [make_data(41), make_data(42)]


@pytest.fixture(scope="module")
def engines(datas, tmp_path_factory):
    je, pe = JaxEngine(), PortEngine(device="cpu")
    js, ps = make_schema(jax_schema), make_schema(port_schema)
    je.register_table(js)
    pe.register_table(ps)
    for i, d in enumerate(datas):
        # persistence round trip on both sides: MV codes + lengths survive
        # save/load (and the dictionaries load as the same Python strings)
        jpath = str(tmp_path_factory.mktemp("jax_mv") / f"s{i}")
        jax_build(js, dict(d), f"s{i}").save(jpath)
        je.add_segment("mv", JaxSegment.load(jpath))
        path = str(tmp_path_factory.mktemp("port_mv") / f"s{i}")
        port_build(ps, dict(d), f"s{i}").save(path)
        pe.add_segment("mv", PortSegment.load(path, verify=True))
    return je, pe


def test_build_matches_jax(datas):
    d = datas[0]
    j = jax_build(make_schema(jax_schema), dict(d), "s0")
    p = port_build(make_schema(port_schema), dict(d), "s0")
    for name in ("tags", "scores"):
        jc, pc = j.column(name), p.column(name)
        assert pc.is_multi_value
        np.testing.assert_array_equal(pc.codes, jc.codes)
        assert pc.codes.dtype == jc.codes.dtype
        np.testing.assert_array_equal(pc.mv_lengths, jc.mv_lengths)
        assert pc.mv_lengths.dtype == jc.mv_lengths.dtype
        np.testing.assert_array_equal(pc.dictionary.values, jc.dictionary.values)
        assert pc.stats.to_dict() == jc.stats.to_dict()
        assert list(map(tuple, pc.decoded())) == list(map(tuple, jc.decoded()))
    assert [list(t) for t in p.column("tags").decoded()] == [list(t) for t in d["tags"]]


def test_ragged_input_builds_the_same_column(datas):
    d = datas[0]
    flat = np.asarray([x for t in d["tags"] for x in t], dtype=object)
    lengths = np.asarray([len(t) for t in d["tags"]], dtype=np.int32)
    ragged = dict(d, tags=RaggedColumn(flat, lengths))
    a = port_build(make_schema(port_schema), dict(d), "s0").column("tags")
    b = port_build(make_schema(port_schema), ragged, "s0").column("tags")
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.mv_lengths, b.mv_lengths)
    # the sorted-column reorder of a ragged column keeps each row's elements
    order = np.argsort(d["v"], kind="stable")
    taken = RaggedColumn(flat, lengths).take(order)
    assert [tuple(x) for x in np.split(taken.values, np.cumsum(taken.lengths)[:-1])] == [
        tuple(d["tags"][i]) for i in order
    ]


# (sql, approximate cell indexes, ordered)
SQL_SET = [
    ("SELECT COUNT(*) FROM mv WHERE tags = 'red'", (), False),
    ("SELECT COUNT(*) FROM mv WHERE tags IN ('red', 'gold')", (), False),
    ("SELECT COUNT(*) FROM mv WHERE tags NOT IN ('red', 'gold')", (), False),
    ("SELECT COUNT(*) FROM mv WHERE tags != 'gray'", (), False),
    ("SELECT COUNT(*) FROM mv WHERE scores > 40", (), False),
    ("SELECT COUNT(*) FROM mv WHERE scores >= 0", (), False),
    ("SELECT COUNT(*) FROM mv WHERE scores BETWEEN 10 AND 12 AND city = 'sf'", (), False),
    ("SELECT COUNTMV(scores), SUMMV(scores), MINMV(scores), MAXMV(scores), AVGMV(scores) FROM mv", (4,), False),
    ("SELECT DISTINCTCOUNTMV(tags), DISTINCTCOUNTMV(scores) FROM mv", (), False),
    ("SELECT city, SUMMV(scores), COUNTMV(scores) FROM mv GROUP BY city ORDER BY city", (), True),
    ("SELECT SUMMV(scores) FROM mv WHERE tags = 'blue'", (), False),
    ("SELECT city, MAXMV(scores), AVGMV(scores) FROM mv WHERE v > 50 GROUP BY city", (2,), False),
    ("SELECT COUNT(*) FROM mv WHERE ARRAYLENGTH(tags) = 2", (), False),
    ("SELECT ARRAYLENGTH(tags), COUNT(*) FROM mv GROUP BY ARRAYLENGTH(tags) ORDER BY ARRAYLENGTH(tags)", (), True),
    ("SELECT CARDINALITY(scores), SUM(v) FROM mv GROUP BY CARDINALITY(scores)", (), False),
    ("SELECT tags, COUNT(*), SUM(v) FROM mv GROUP BY tags ORDER BY tags LIMIT 100", (), True),
    ("SELECT city, tags, COUNT(*) FROM mv GROUP BY city, tags ORDER BY city, tags LIMIT 100", (), True),
    ("SELECT tags, COUNT(*) FROM mv WHERE v > 50 GROUP BY tags ORDER BY tags LIMIT 100", (), True),
    ("SELECT scores, MIN(v), MAX(v) FROM mv WHERE tags = 'red' GROUP BY scores LIMIT 100", (), False),
    ("SET maxDenseGroups = 4; SELECT city, tags, COUNT(*), SUM(v) FROM mv GROUP BY city, tags LIMIT 100",
     (), False),
    ("SET maxDenseGroups = 4; SELECT tags, SUM(v) FROM mv GROUP BY tags ORDER BY SUM(v) DESC LIMIT 3", (), True),
    ("SET maxDenseGroups = 2; SELECT city, SUMMV(scores), DISTINCTCOUNTMV(scores) FROM mv GROUP BY city "
     "ORDER BY SUMMV(scores) DESC LIMIT 2", (), True),
    ("SELECT city, UNNEST(tags) FROM mv WHERE v > 90 LIMIT 100000", (), False),
    ("SELECT UNNEST(scores) FROM mv LIMIT 1000000", (), False),
]


@pytest.mark.parametrize("sql,approx,ordered", SQL_SET, ids=[q[0][:70] for q in SQL_SET])
def test_sql_set_matches_jax(engines, sql, approx, ordered):
    je, pe = engines
    want, got = je.query(sql), pe.query(sql)
    assert_rows_match(got.rows, want.rows, approx, ordered)
    assert got.stats.num_docs_scanned == want.stats.num_docs_scanned


def test_goldens(engines, datas):
    """A few answers against Python over the raw rows (both segments)."""
    _, pe = engines
    tags = [t for d in datas for t in d["tags"]]
    scores = [s for d in datas for s in d["scores"]]
    v = np.concatenate([d["v"] for d in datas])
    assert pe.query("SELECT COUNT(*) FROM mv WHERE tags NOT IN ('red', 'gold')").rows[0][0] == sum(
        1 for t in tags if any(x not in ("red", "gold") for x in t))
    flat = [x for s in scores for x in s]
    row = pe.query("SELECT COUNTMV(scores), SUMMV(scores), MINMV(scores), MAXMV(scores) FROM mv").rows[0]
    assert tuple(row) == (len(flat), sum(flat), min(flat), max(flat))
    counts, sums = Counter(), Counter()
    for t_list, vv in zip(tags, v):
        for t in t_list:
            counts[t] += 1
            sums[t] += int(vv)
    got = {r[0]: (int(r[1]), int(r[2])) for r in pe.query(
        "SELECT tags, COUNT(*), SUM(v) FROM mv GROUP BY tags ORDER BY tags LIMIT 100").rows}
    assert got == {k: (counts[k], sums[k]) for k in counts}
    # empty-MV rows consume no LIMIT slot of an UNNEST
    assert len(pe.query("SELECT UNNEST(tags) FROM mv LIMIT 7").rows) == 7


@pytest.mark.parametrize(
    "sql,exc",
    [
        ("SELECT tags, SUMMV(scores) FROM mv GROUP BY tags", NotImplementedError),
        ("SELECT tags, scores, COUNT(*) FROM mv GROUP BY tags, scores", NotImplementedError),
        ("SELECT SUMMV(v) FROM mv", ValueError),
        ("SELECT SUMMV(tags) FROM mv", ValueError),
        ("SELECT UNNEST(city) FROM mv LIMIT 5", ValueError),
    ],
)
def test_refusals_match_jax(engines, sql, exc):
    je, pe = engines
    for eng in (je, pe):
        with pytest.raises(exc):
            eng.query(sql)


def test_jax_saved_segment_loads_into_the_port(datas, tmp_path):
    js = make_schema(jax_schema)
    path = str(tmp_path / "jax_mv")
    jax_build(js, dict(datas[0]), "s0").save(path)
    seg = PortSegment.load(path, verify=True)
    assert seg.column("tags").is_multi_value
    assert list(map(tuple, seg.column("scores").decoded())) == [tuple(s) for s in datas[0]["scores"]]
    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(js)
    pe.register_table(make_schema(port_schema))
    je.add_segment("mv", JaxSegment.load(path))
    pe.add_segment("mv", seg)
    for sql in ("SELECT tags, COUNT(*), SUM(v) FROM mv GROUP BY tags LIMIT 100",
                "SELECT SUMMV(scores), DISTINCTCOUNTMV(tags) FROM mv WHERE scores > 30"):
        assert_rows_match(pe.query(sql).rows, je.query(sql).rows)


def test_mv_explode_launches_the_fused_scan(engines, monkeypatch):
    """Planned for the kernel backend, the dense MV group-by sends the
    exploded key to fused_scan.fused_group_tables (the wrapper that
    launches the CUDA kernel on CUDA tensors): one call a segment, the
    computed int32 key's instantiation."""
    je, pe = engines
    port_planner.plan_cache_clear()
    calls = spy_kernel_calls(monkeypatch, port_planner)
    sql = "SELECT tags, COUNT(*), SUM(v) FROM mv WHERE v > 10 GROUP BY tags LIMIT 100"
    got = pe.query(sql)
    assert_rows_match(got.rows, je.query(sql).rows)
    assert len(calls) == 2
    assert {c["variant"] for c in calls} == {"i32/i32/shared"}
    port_planner.plan_cache_clear()


def test_explode_plain_scan_matches_pallas_and_xla(engines):
    """The exploded MV launch shape through the port's plain fused scan
    equals the JAX package's Pallas kernel (interpret) and XLA path."""
    _, pe = engines
    seg = pe.table("mv").segments[0]
    c = seg.column("tags")
    card = c.dictionary.cardinality
    v = seg.column("v").values.astype(np.int32)
    rng = np.random.default_rng(5)
    tmask = rng.random(seg.num_docs) < 0.7
    cols = seg.to_device("cpu", ["tags", "v"])
    gd = port_planner.GroupDim(None, "tags", "dict", card, dictionary=c.dictionary, mv=True)
    tm = torch.from_numpy(tmask)
    key, t_f, inputs = port_planner.mv_explode(
        cols, [gd], 0, seg, torch.device("cpu"), tm, [(cols["v"]["values"], tm), (tm, tm)])
    # the numpy explode: one row per (row, element slot), masked by length
    width = c.codes.shape[1]
    want_key = np.minimum(c.codes.astype(np.int32), card - 1).reshape(-1)
    want_mask = (tmask[:, None] & (np.arange(width)[None, :] < c.mv_lengths[:, None])).reshape(-1)
    np.testing.assert_array_equal(key.numpy(), want_key)
    np.testing.assert_array_equal(t_f.numpy(), want_mask)
    np.testing.assert_array_equal(inputs[0][0].numpy(), np.repeat(v, width))
    assert inputs[1][1] is t_f  # COUNT(*) shares the row mask: the scan reads it once
    entries = [("count", None, want_mask, None), ("int_sum", np.repeat(v, width), want_mask, (1, False))]
    got = fused_scan.fused_group_tables(
        [(k, None if x is None else torch.from_numpy(x), torch.from_numpy(m), lp) for k, x, m, lp in entries],
        key, card)
    jent = [(k, jnp.zeros(len(m), jnp.int32) if x is None else jnp.asarray(x), jnp.asarray(m), lp)
            for k, x, m, lp in entries]
    pallas = pallas_scan.fused_group_tables_pallas(jent, jnp.asarray(want_key), card, interpret=True)
    xla = jax_segmented.fused_group_tables(jent, jnp.asarray(want_key), card, backend="xla")
    for ref in (pallas, xla):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


DIST_SQL = [
    "SELECT COUNT(*) FROM mv WHERE tags = 'red'",
    "SELECT COUNT(*) FROM mv WHERE tags NOT IN ('red', 'gold') AND scores < 20",
    "SELECT COUNTMV(scores), SUMMV(scores), MINMV(scores), MAXMV(scores) FROM mv",
    "SELECT DISTINCTCOUNTMV(tags) FROM mv WHERE v > 30",
    "SELECT city, SUMMV(scores) FROM mv WHERE tags != 'gray' GROUP BY city ORDER BY city",
    "SELECT ARRAYLENGTH(tags), COUNT(*) FROM mv GROUP BY ARRAYLENGTH(tags)",
    "SET maxDenseGroups = 2; SELECT city, SUMMV(scores), COUNT(*) FROM mv GROUP BY city LIMIT 10",
]


@pytest.fixture(scope="module")
def dist_engines(datas):
    data = datas[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
        jax_ops.scan_backend.cache_clear()
        js = JaxStacked.build(make_schema(jax_schema), dict(data), num_shards=1)
        ps = PortStacked.build(make_schema(port_schema), dict(data), num_shards=1)
        out = []
        for lb in (None, 6_000):  # one launch, and several
            je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=lb)
            pe = PortDist(device="cpu", launch_bytes=lb)
            je.register_table("mv", js)
            pe.register_table("mv", ps)
            out.append((je, pe))
        yield js, ps, out
    jax_ops.scan_backend.cache_clear()


def test_stacked_mv_column_matches_jax(dist_engines):
    js, ps, _ = dist_engines
    for name in ("tags", "scores"):
        np.testing.assert_array_equal(ps.column(name).codes, js.column(name).codes)
        np.testing.assert_array_equal(ps.column(name).mv_lengths, js.column(name).mv_lengths)


@pytest.mark.parametrize("sql", DIST_SQL)
def test_dist_sql_matches_jax(dist_engines, sql):
    _, _, pairs = dist_engines
    for je, pe in pairs:
        assert_rows_match(pe.query(sql).rows, je.query(sql).rows)
    pe = pairs[1][1]
    assert len(pe._plan(port_parse(sql), pe.tables["mv"]).batch_offsets) > 1  # several launches


def test_dist_mv_groupby_refused_like_jax(dist_engines):
    _, _, pairs = dist_engines
    je, pe = pairs[0]
    for eng in (je, pe):
        with pytest.raises(NotImplementedError, match="MV GROUP BY"):
            eng.query("SELECT tags, COUNT(*) FROM mv GROUP BY tags")


@pytest.mark.parametrize("sql", [
    "SELECT city, tags FROM mv WHERE v > 96 LIMIT 10000",
    "SELECT * FROM mv LIMIT 5",
    "SELECT city, v FROM mv ORDER BY scores DESC, v LIMIT 10",
])
def test_dist_mv_selection_refused(dist_engines, sql):
    """A distributed selection of (or ordered by) an MV column: the JAX
    engine has no MV row gather and faults with an IndexError (a reference
    fault, ROADMAP Queue 3); the port refuses it with NotImplementedError."""
    _, _, pairs = dist_engines
    je, pe = pairs[0]
    with pytest.raises(IndexError):
        je.query(sql)
    with pytest.raises(NotImplementedError, match="multi-value column"):
        pe.query(sql)
