"""The port's macro-batched DistributedEngine against the JAX package's.

The same numpy data (3001 rows: not a multiple of 32, so `valid` padding
shows; a nullable string column, a nullable float column, a range index, an
inverted index and a sorted column) goes into the JAX StackedTable.build +
DistributedEngine on a one-device mesh, under PINOT_TPU_SCAN_BACKEND=
interpret so the JAX side takes its word-fused Pallas route in interpret
mode, and into the port's StackedTable.build + DistributedEngine(device=
"cpu").  Every query runs at one batch and again at a launch_bytes that
forces four batches with a ragged tail.

Tolerance: rows compare EXACTLY (value and Python type), integer-valued
SUMs included, except the cells marked approximate (aggregates of the float
column), which compare with rtol=1e-12 because the packages add floats in
different orders.  The plans must agree on kind, launch schedule, the
row-sharded (per-launch sliced) bitmap params and whether the sparse path
merges on the device.  The port's sparse_grouped_tables and
merge_sparse_tables are also held against the JAX functions directly.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from pinot_tpu import ops as jax_ops
from pinot_tpu.ops import pallas_scan
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.query import functions as jax_functions
from pinot_tpu.query import planner as jax_planner
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.sql.parser import parse_query as jax_parse

from pinot_tpu_torch.ops import sparse_merge
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.query import functions as port_functions
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import parse_query as port_parse

from test_torch_query import assert_rows_match, build_engines, spy_kernel_calls
from test_torch_query import make_data as sse_make_data

N = 3001
CITIES = ["sf", "nyc", "chi", "la", "sea"]


def make_data(seed=7, n=N):
    rng = np.random.default_rng(seed)
    return {
        "d": (19920101 + rng.integers(0, 300, n)).astype(np.int32),
        "q": rng.integers(1, 51, n).astype(np.int32),
        "disc": rng.integers(0, 11, n).astype(np.int32),
        "city": np.asarray([CITIES[i] if i < len(CITIES) else None for i in rng.integers(0, 6, n)], dtype=object),
        "yr": rng.integers(2000, 2024, n).astype(np.int32),
        "rev": rng.integers(100, 1_000_000, n).astype(np.int64),
        "price": np.where(rng.random(n) < 0.15, np.nan, np.round(rng.random(n) * 100, 3)),
    }


def make_schema(S):
    return S.Schema(
        "t",
        [
            S.FieldSpec("d", S.DataType.INT),
            S.FieldSpec("q", S.DataType.INT),
            S.FieldSpec("disc", S.DataType.INT),
            S.FieldSpec("city", S.DataType.STRING, nullable=True),
            S.FieldSpec("yr", S.DataType.INT),
            S.FieldSpec("rev", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("price", S.DataType.DOUBLE, role=S.FieldRole.METRIC, nullable=True),
        ],
    )


def make_config(C):
    return C.TableConfig(
        "t",
        indexing=C.IndexingConfig(
            inverted_index_columns=["disc", "city"], range_index_columns=["q"], sorted_column="yr"
        ),
    )


def _stacked_pair(num_shards=1):
    data = make_data()
    js = JaxStacked.build(make_schema(jax_schema), dict(data), num_shards=num_shards,
                          table_config=make_config(jax_config))
    ps = PortStacked.build(make_schema(port_schema), dict(data), num_shards=num_shards,
                           table_config=make_config(port_config))
    return js, ps


def _launch_bytes_for(ps, batches: int) -> int:
    """A launch_bytes under which the table splits into `batches` launches
    (the batching arithmetic's bytes per doc over the whole table)."""
    eng = PortDist(device="cpu", launch_bytes=1 << 40)
    bpd = 0.0
    for c in ps.columns.values():
        if c.codes is not None:
            bpd += c.code_bits / 8.0 if c.code_bits else c.codes.dtype.itemsize
        if c.values is not None:
            bpd += c.values.dtype.itemsize
        if c.nulls is not None:
            bpd += 1
    del eng
    return int(bpd * ps.num_shards * ps.docs_per_shard) // batches + 1


@pytest.fixture(scope="module")
def engines():
    """{"one" | "many": (jax engine, port engine)} over one table pair,
    the JAX side on the interpret (Pallas) scan backend."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
        jax_ops.scan_backend.cache_clear()
        js, ps = _stacked_pair()
        out = {}
        for label, lb in (("one", None), ("many", _launch_bytes_for(ps, 4))):
            je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=lb, pipeline_depth=2)
            pe = PortDist(device="cpu", launch_bytes=lb, pipeline_depth=2)
            je.register_table("t", js)
            pe.register_table("t", ps)
            out[label] = (je, pe)
        yield out
    jax_ops.scan_backend.cache_clear()


BENCH_Q = "SELECT d, SUM(rev) FROM t WHERE q < 25 GROUP BY d LIMIT 2500"
DIST_FILTER_Q = (
    "SELECT d, COUNT(*), SUM(rev) FILTER (WHERE disc BETWEEN 1 AND 3), SUM(rev * disc) FROM t WHERE q < 25 "
    "GROUP BY d LIMIT 2500"
)
DIST_MOD_Q = (
    "SELECT MOD(d, 100), COUNT(*), SUM(CASE WHEN disc > 5 THEN rev ELSE 0 END) FROM t WHERE q < 25 "
    "GROUP BY MOD(d, 100) ORDER BY MOD(d, 100) LIMIT 100"
)
SPARSE_Q = "SET maxDenseGroups = 2; SELECT disc, SUM(rev), COUNT(*) FROM t GROUP BY disc ORDER BY disc LIMIT 10"
SPARSE_ORDER_Q = "SET maxDenseGroups = 2; SELECT disc, SUM(rev) FROM t GROUP BY disc ORDER BY SUM(rev) DESC LIMIT 3"

# (sql, approximate cell indexes, ordered)
DIST_SET = [
    (BENCH_Q, (), False),
    ("SELECT SUM(rev), COUNT(*) FROM t WHERE disc BETWEEN 1 AND 3 AND q < 25", (), False),
    ("SELECT disc, q, COUNT(*), SUM(rev), MIN(rev), MAX(rev) FROM t WHERE q < 25 "
     "GROUP BY disc, q ORDER BY SUM(rev) DESC LIMIT 10", (), True),
    ("SET numGroupsLimit = 2000000; SET maxDenseGroups = 1000; SELECT d, q, disc, SUM(rev), COUNT(*) "
     "FROM t WHERE q < 25 GROUP BY d, q, disc ORDER BY SUM(rev) DESC LIMIT 100", (), True),
    (SPARSE_Q, (), True),
    (SPARSE_ORDER_Q, (), True),
    # per-launch and merged numGroupsLimit trims, each ORDER BY mode of the
    # device merge (sum, count, max, min) and the host merge (AVG order)
    ("SET maxDenseGroups = 2; SET numGroupsLimit = 40; SELECT d, SUM(rev) FROM t GROUP BY d "
     "ORDER BY SUM(rev) DESC LIMIT 10", (), True),
    ("SET maxDenseGroups = 2; SET numGroupsLimit = 40; SELECT q, disc, COUNT(*) FROM t GROUP BY q, disc "
     "ORDER BY COUNT(*) DESC LIMIT 10", (), False),
    ("SET maxDenseGroups = 2; SET numGroupsLimit = 60; SELECT d, MAX(rev) FROM t GROUP BY d "
     "ORDER BY MAX(rev) DESC LIMIT 10", (), True),
    ("SET maxDenseGroups = 2; SET numGroupsLimit = 60; SELECT d, MIN(price), COUNT(*) FROM t GROUP BY d "
     "ORDER BY MIN(price) LIMIT 10", (), False),
    ("SET maxDenseGroups = 2; SET numGroupsLimit = 30; SELECT city, q, AVG(rev) FROM t GROUP BY city, q "
     "ORDER BY AVG(rev) DESC LIMIT 5", (2,), True),
    ("SET maxDenseGroups = 2; SELECT d, COUNT(*) FROM t GROUP BY d LIMIT 5000", (), False),
    # nulls, the inverted index (word-fused too), the sorted column's doc range
    ("SELECT city, COUNT(*), COUNT(city), SUM(price), MIN(price) FROM t GROUP BY city LIMIT 10", (3,), False),
    ("SELECT d, COUNT(*), SUM(rev) FROM t WHERE disc IN (1, 2, 7) GROUP BY d LIMIT 5000", (), False),
    ("SELECT COUNT(*), SUM(rev), MAX(price) FROM t WHERE yr BETWEEN 2005 AND 2010", (), False),
    ("SELECT yr, COUNT(*) FROM t WHERE yr >= 2020 AND city = 'sf' GROUP BY yr LIMIT 100", (), False),
    ("SELECT COUNT(*), AVG(price) FROM t WHERE price IS NULL OR q > 40", (1,), False),
    ("SELECT q, SUM(rev) FROM t WHERE city != 'la' GROUP BY q ORDER BY q LIMIT 100", (), True),
    # FILTER (WHERE ...) masks beside the words, expression values and keys
    (DIST_FILTER_Q, (), False),
    ("SELECT SUM(rev * disc) FROM t WHERE disc BETWEEN 1 AND 3 AND q < 25", (), False),
    (DIST_MOD_Q, (), True),
    ("SELECT city, COUNT(*) FILTER (WHERE q > 40), MIN(rev) FILTER (WHERE disc = 3), SUM(price) FILTER "
     "(WHERE yr > 2010) FROM t WHERE q < 25 GROUP BY city LIMIT 10", (3,), False),
    ("SET maxDenseGroups = 2; SELECT UPPER(city), q - 1, SUM(rev) FILTER (WHERE disc < 5), COUNT(*) FROM t "
     "GROUP BY UPPER(city), q - 1 LIMIT 1000", (), False),
    ("SELECT yr - 2000, SUM(CASE WHEN price > 50 THEN 1 ELSE 0 END), AVG(rev * 1.5) FROM t "
     "GROUP BY yr - 2000 LIMIT 100", (2,), False),
]


@pytest.mark.parametrize("batching", ["one", "many"])
@pytest.mark.parametrize("sql,approx,ordered", DIST_SET, ids=[q[0][:70] for q in DIST_SET])
def test_dist_matches_jax(engines, sql, approx, ordered, batching):
    je, pe = engines[batching]
    jplan = je._plan(jax_parse(sql), je.tables["t"])
    pplan = pe._plan(port_parse(sql), pe.tables["t"])
    assert pplan.kind == jplan.kind
    assert pplan.batch_docs == jplan.batch_docs
    assert pplan.batch_offsets == jplan.batch_offsets
    assert pplan.row_sharded_params == jplan.row_sharded_params
    assert (pplan.sparse_merge_fn is not None) == (jplan.sparse_merge_fn is not None)
    if batching == "many":
        assert len(pplan.batch_offsets) >= 3 and pplan.batch_offsets[-1][1] > 0, pplan.batch_offsets
    want = je.query(sql)
    got = pe.query(sql)
    assert_rows_match(got.rows, want.rows, approx, ordered)
    assert got.stats.filter_index_uses == want.stats.filter_index_uses
    assert got.stats.num_docs_scanned == want.stats.num_docs_scanned


def test_bench_query_is_word_fused(engines):
    for batching in ("one", "many"):
        _, pe = engines[batching]
        plan = pe._plan(port_parse(BENCH_Q), pe.tables["t"])
        assert plan.kind == "groupby_dense" and plan.word_fused
        assert len(plan.row_sharded_params) == 1
        assert plan.needed_columns == ["d", "rev"]  # q answered by the range index


def test_sparse_device_merge_where_jax_has_one(engines):
    _, pe = engines["many"]
    for sql in (SPARSE_Q, SPARSE_ORDER_Q):
        plan = pe._plan(port_parse(sql), pe.tables["t"])
        assert plan.kind == "groupby_sparse" and plan.sparse_merge_fn is not None
    host = pe._plan(port_parse(DIST_SET[10][0]), pe.tables["t"])
    assert host.kind == "groupby_sparse" and host.sparse_merge_fn is None  # AVG order: host merge


def test_two_shards_at_one_device_match_jax():
    """L = 2 local shards at one device: flat [S * Db] rows, words sliced
    per shard."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
        jax_ops.scan_backend.cache_clear()
        try:
            js, ps = _stacked_pair(num_shards=2)
            lb = _launch_bytes_for(ps, 3)
            je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=lb)
            pe = PortDist(device="cpu", launch_bytes=lb)
            je.register_table("t", js)
            pe.register_table("t", ps)
            for sql, approx, ordered in (DIST_SET[0], DIST_SET[2], DIST_SET[3], DIST_SET[14]):
                assert pe._plan(port_parse(sql), ps).batch_offsets == je._plan(jax_parse(sql), js).batch_offsets
                assert_rows_match(pe.query(sql).rows, je.query(sql).rows, approx, ordered)
        finally:
            jax_ops.scan_backend.cache_clear()


def test_stacked_table_matches_jax():
    js, ps = _stacked_pair()
    assert (ps.num_shards, ps.docs_per_shard, ps.num_docs) == (js.num_shards, js.docs_per_shard, js.num_docs)
    assert ps.docs_per_shard % 32 == 0 and ps.docs_per_shard > ps.num_docs
    np.testing.assert_array_equal(ps.valid, js.valid)
    for name, jc in js.columns.items():
        pc = ps.column(name)
        for attr in ("codes", "values", "nulls", "packed"):
            a, b = getattr(pc, attr), getattr(jc, attr)
            assert (a is None) == (b is None), (name, attr)
            if a is not None:
                assert a.dtype == b.dtype, (name, attr)
                np.testing.assert_array_equal(a, b)
        assert pc.code_bits == jc.code_bits
        if jc.dictionary is not None:
            assert pc.dictionary.fingerprint() == jc.dictionary.fingerprint()
        assert pc.stats.is_sorted == jc.stats.is_sorted
    assert {k: sorted(v) for k, v in ps.indexes.items()} == {k: sorted(v) for k, v in js.indexes.items()}
    np.testing.assert_array_equal(ps.indexes["range"]["q"].prefix, js.indexes["range"]["q"].prefix)
    np.testing.assert_array_equal(ps.indexes["inverted"]["city"].bitmaps, js.indexes["inverted"]["city"].bitmaps)
    assert ps.column_names == js.column_names
    for name in ("city", "rev", "price"):
        a, b = ps.decoded_flat(name), js.decoded_flat(name)
        assert len(a) == len(b) and all(x == y or (x != x and y != y) for x, y in zip(a, b))


def test_to_device_slices_and_caches():
    _, ps = _stacked_pair()
    cols, valid = ps.to_device("cpu", ["d", "rev", "price"], doc_slice=(64, 640), packed_codes=True)
    assert valid.shape == (1, 576) and bool(valid.all())
    d = cols["d"]
    assert "codes_packed" in d and "codes" not in d
    from pinot_tpu_torch.segment.packing import unpack_codes_torch

    codes = unpack_codes_torch(d["codes_packed"].reshape(-1), ps.column("d").code_bits, 576)
    np.testing.assert_array_equal(codes.numpy(), ps.column("d").codes[0, 64:640])
    np.testing.assert_array_equal(cols["rev"]["values"].numpy(), ps.column("rev").values[:, 64:640])
    assert cols["price"]["nulls"].dtype == torch.bool
    again, _ = ps.to_device("cpu", ["d"], doc_slice=(64, 640), packed_codes=True)
    assert again["d"] is d
    unpacked, _ = ps.to_device("cpu", ["d"], doc_slice=(64, 640), with_valid=False)
    assert "codes" in unpacked["d"] and unpacked["d"] is not d


def test_literal_sweep_plans_once():
    _, ps = _stacked_pair()
    pe = PortDist(device="cpu", launch_bytes=_launch_bytes_for(ps, 3))
    pe.register_table("t", ps)
    rows = []
    for i in range(20):
        rows.append(pe.query(f"SELECT d, SUM(rev) FROM t WHERE q < {5 + (i % 40)} GROUP BY d LIMIT 2500").rows)
    assert (pe.plan_misses, pe.plan_hits) == (1, 19)
    assert len(rows[0]) < len(rows[-1])  # literals rebound, not baked


def test_unported_paths_raise():
    _, ps = _stacked_pair()
    pe = PortDist(device="cpu")
    pe.register_table("t", ps)
    # as in the JAX package: selections take bare columns only
    with pytest.raises(NotImplementedError, match="only bare columns"):
        pe.query("SELECT d, rev * 2 FROM t LIMIT 5")
    with pytest.raises(NotImplementedError, match="only bare columns"):
        pe.query("SELECT d, RANK() OVER (ORDER BY rev) FROM t LIMIT 5")
    with pytest.raises(NotImplementedError, match="item 4"):
        pe.query("SELECT PERCENTILE(rev, 50) FROM t")
    with pytest.raises(NotImplementedError, match="item 6"):
        pe.execute_many([port_parse(BENCH_Q)])
    # residency (item 3) is ported: a budget makes a manager, and a
    # prefetch without one takes the plain cache, as in the JAX package
    assert PortDist(device="cpu", hbm_cache_bytes=1 << 20).residency.budget.budget_bytes == 1 << 20
    assert PortDist(device="cpu", hbm_cache_bytes=0).residency is None
    cols, _ = ps.to_device("cpu", ["d"], prefetch=True)
    assert set(cols) == {"d"}


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortDist()
    with pytest.raises(RuntimeError, match="CUDA"):
        PortStacked.build(make_schema(port_schema), make_data(n=64), num_shards=1).to_device(None, ["d"])


# -- the sparse path's functions, held against the JAX functions -------------
SPARSE_AGGS = ("sum", "count", "max", "min")


def _sparse_inputs(seed, n=2000):
    """(key, tmask, [(values, mask)] per SPARSE_AGGS) with few distinct
    values, so group sums, counts and extremes tie."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 300, n).astype(np.int64) * 7
    tmask = rng.random(n) < 0.8
    vals = rng.integers(0, 4, n).astype(np.int64)
    inputs = [(vals, tmask & (rng.random(n) < 0.9)), (tmask, tmask),
              (vals, tmask & (rng.random(n) < 0.7)), (rng.integers(-3, 3, n).astype(np.int64), tmask)]
    return key, tmask, inputs


@pytest.mark.parametrize("order_spec", [None, (0, "sum", False), (0, "sum", True), (1, "count", False),
                                        (2, "max", False), (3, "min", True), (3, "min", False)])
@pytest.mark.parametrize("num_slots", [25, 400])
def test_sparse_grouped_tables_matches_jax(order_spec, num_slots):
    key, tmask, inputs = _sparse_inputs(3)
    jfns = [jax_functions.get_agg_function(a) for a in SPARSE_AGGS]
    pfns = [port_functions.get_agg_function(a) for a in SPARSE_AGGS]
    ju, jp = jax_planner.sparse_grouped_tables(
        jfns, [(jnp.asarray(v), jnp.asarray(m)) for v, m in inputs], jnp.asarray(tmask), jnp.asarray(key),
        num_slots, order_spec,
    )
    pu, pp = port_planner.sparse_grouped_tables(
        pfns, [(torch.from_numpy(v), torch.from_numpy(m)) for v, m in inputs], torch.from_numpy(tmask),
        torch.from_numpy(key), num_slots, order_spec,
    )
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    for jd, pd in zip(jp, pp):
        assert set(jd) == set(pd)
        for f in jd:
            assert pd[f].dtype == {"count": torch.int64}.get(f, torch.float64)
            np.testing.assert_array_equal(pd[f].numpy(), np.asarray(jd[f]))


def _stacked_tables(seed, launches=3, K=64):
    """Per-launch sparse tables as the sparse path makes them: ascending
    unique keys, SPARSE_EMPTY_KEY padding, keys shared across launches and
    order values that tie."""
    rng = np.random.default_rng(seed)
    empty = int(port_planner.SPARSE_EMPTY_KEY)
    uniq, sums, counts, maxs = [], [], [], []
    for _ in range(launches):
        live = int(rng.integers(K // 2, K + 1))
        keys = np.full(K, empty, np.int64)
        keys[:live] = np.sort(rng.choice(150, live, replace=False)) * 3
        cnt = np.zeros(K, np.int64)
        cnt[:live] = rng.integers(0, 3, live)
        sm = np.where(cnt > 0, rng.integers(0, 5, K), 0).astype(np.float64)
        mx = np.where(cnt > 0, rng.integers(0, 5, K).astype(np.float64), -np.inf)
        uniq.append(keys), sums.append(sm), counts.append(cnt), maxs.append(mx)
    parts = [{"sum": np.concatenate(sums), "count": np.concatenate(counts)},
             {"max": np.concatenate(maxs), "count": np.concatenate(counts)}]
    return np.concatenate(uniq), parts


@pytest.mark.parametrize("order_spec", [None, (0, "sum", False), (0, "sum", True), (1, "max", False)])
@pytest.mark.parametrize("num_slots", [20, 150])
def test_merge_sparse_tables_matches_jax(order_spec, num_slots):
    uniq, parts = _stacked_tables(11)
    field_ops = [{f: jax_functions.FIELD_COMBINE[f] for f in p} for p in parts]
    ju, jp = pallas_scan.merge_sparse_tables(
        jnp.asarray(uniq), [{f: jnp.asarray(a) for f, a in p.items()} for p in parts], num_slots, field_ops,
        order_spec=order_spec,
    )
    pu, pp = sparse_merge.merge_sparse_tables(
        torch.from_numpy(uniq), [{f: torch.from_numpy(a) for f, a in p.items()} for p in parts], num_slots,
        field_ops, order_spec=order_spec,
    )
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    for jd, pd in zip(jp, pp):
        for f in jd:
            np.testing.assert_array_equal(pd[f].numpy(), np.asarray(jd[f]))


def test_grouped_partials_unpacks_words_for_min_max():
    """mask_words with a non-fusable aggregation: the words are unpacked
    into the masks, and the tables equal the plain masked run's."""
    rng = np.random.default_rng(5)
    n, g = 256, 9
    key = torch.from_numpy(rng.integers(0, g, n).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-50, 50, n).astype(np.int64))
    bits = rng.random(n) < 0.5
    words = torch.from_numpy(np.packbits(bits.reshape(-1, 32), axis=1, bitorder="little").view(np.int32).reshape(-1))
    ones = torch.ones(n, dtype=torch.bool)
    aggs = [port_functions.get_agg_function(a) for a in ("sum", "min", "max")]
    got = port_planner.grouped_partials(aggs, [(vals, ones)] * 3, ones, lambda: key, g, [None] * 3,
                                        backend="torch", mask_words=words)
    m = torch.from_numpy(bits)
    want = port_planner.grouped_partials(aggs, [(vals, m)] * 3, m, lambda: key, g, [None] * 3, backend="torch")
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert a.keys() == b.keys() and all(torch.equal(a[f], b[f]) for f in a)


# -- the SSE engine's sparse group-by ------------------------------------------
SSE_SPARSE = [
    ("SET maxDenseGroups = 2; SELECT city, SUM(v), COUNT(*) FROM t GROUP BY city LIMIT 100", ()),
    ("SET maxDenseGroups = 2; SELECT city, year, COUNT(*), MIN(v), MAX(price) FROM t "
     "GROUP BY city, year ORDER BY COUNT(*) DESC, city, year LIMIT 20", ()),
    ("SET maxDenseGroups = 2; SELECT day, SUM(v) FROM t GROUP BY day ORDER BY SUM(v) DESC LIMIT 5", ()),
    ("SET maxDenseGroups = 2; SET numGroupsLimit = 7; SELECT day, SUM(v) FROM t GROUP BY day "
     "ORDER BY SUM(v) DESC LIMIT 3", ()),
    ("SET maxDenseGroups = 2; SELECT tag, AVG(price) FROM t WHERE year > 2010 GROUP BY tag LIMIT 10", (1,)),
]


@pytest.fixture(scope="module")
def sse_engines():
    datas = [sse_make_data(seed) for seed in (1, 2)]
    return build_engines({"t": (True, datas)})


@pytest.mark.parametrize("sql,approx", SSE_SPARSE, ids=[q[0][:70] for q in SSE_SPARSE])
def test_sse_sparse_groupby_matches_jax(sse_engines, sql, approx):
    jax_engine, port_engine = sse_engines
    want = jax_engine.query(sql)
    got = port_engine.query(sql)
    assert_rows_match(got.rows, want.rows, approx, ordered="ORDER BY" in sql)
    assert got.stats.num_groups == want.stats.num_groups


@pytest.mark.parametrize("sql,variant,masks", [(DIST_FILTER_Q, "p16/i32/shared", 2), (DIST_MOD_Q, "i32/i32/shared", 1)])
def test_dist_slice_entry_sets_reach_the_kernel(engines, monkeypatch, sql, variant, masks):
    """On the word-fused path the FILTER masks go to the kernel beside the
    range-index words (mask_words); a computed key takes the int32 key
    instantiation.  One call a launch."""
    _, ps = _stacked_pair()
    calls = spy_kernel_calls(monkeypatch, port_planner)
    pe = PortDist(device="cpu", launch_bytes=_launch_bytes_for(ps, 4))
    pe.register_table("t", ps)
    plan = pe._plan(port_parse(sql), ps)
    assert plan.word_fused
    rows = pe.query(sql).rows
    assert len(calls) == len(plan.batch_offsets) >= 3
    for c in calls:
        assert c["variant"] == variant and c["masks"] == masks and c["mask_words"], c
    assert_rows_match(rows, engines["many"][0].query(sql).rows, ordered="ORDER BY" in sql)
