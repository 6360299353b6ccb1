"""The port's multi-stage join engine against the JAX package's.

Every case of tests/test_mse_join.py, tests/test_mse_join_general.py and
tests/test_index_filters.py::test_mse_join_with_indexed_fact_filter runs
the same seeded numpy data through both packages: the JAX DistributedEngine
on the 8-device CPU mesh (tests/conftest.py) over StackedTable.build(...,
8), and the port's DistributedEngine(device="cpu") over num_shards=8
tables, which routes joins to its mse.MultiStageEngine.  Results are held
equal (integers exactly, floats to rtol 1e-9, cell types equal), against
sqlite where the JAX test uses it, and every error path raises the same
exception type in both.  The port-only cases cover string join keys, NULL
keys on both sides, the LEFT JOIN's NULL slot past the dictionary, the
slack in the plan-cache key, the perf ledger record and the backend tag a
join group-by plans with.
"""
import sqlite3

import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.mse import JoinPlanError as JaxJoinPlanError
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.sql.parser import SqlParseError as JaxSqlParseError
from pinot_tpu.utils.metrics import METRICS as JAX_METRICS

from pinot_tpu_torch.mse import JoinPlanError, MultiStageEngine
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import SqlParseError
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS
from pinot_tpu_torch.utils.perf import PERF_LEDGER as PORT_LEDGER

from test_mse_join import _mn_env, _mn_sqlite, make_ssb, sqlite_rows
from test_torch_sketches import assert_same_rows

S = jax_schema
SHARDS = 8
STRATEGIES = ["broadcast", "shuffle"]


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    PORT_METRICS.reset()
    PORT_LEDGER.reset()
    yield


class Pair:
    """A JAX DistributedEngine on the 8-device CPU mesh and the port's on
    the CPU, over the same tables (8 shards each)."""

    def __init__(self):
        self.jax = JaxDist()
        self.port = PortDist(device="cpu")

    def add(self, name, schema, data, config=None):
        """schema: a JAX Schema; config: fn(config module) -> TableConfig."""
        self.jax.register_table(name, JaxStacked.build(
            schema, dict(data), self.jax.num_devices, table_config=config(jax_config) if config else None))
        self.port.register_table(name, PortStacked.build(
            port_schema.Schema.from_dict(schema.to_dict()), dict(data), SHARDS,
            table_config=config(port_config) if config else None))
        return self

    def same(self, sql, ordered=True):
        """The port's rows equal the JAX engine's; returns them."""
        got, want = self.port.query(sql).rows, self.jax.query(sql).rows
        assert_same_rows(got, want, ordered=ordered)
        return got

    def raises(self, sql, jax_exc, port_exc, match=None):
        with pytest.raises(jax_exc, match=match):
            self.jax.query(sql)
        with pytest.raises(port_exc, match=match):
            self.port.query(sql)


def _ints(rows):
    return [tuple(None if v is None else (v if isinstance(v, str) else int(v)) for v in r) for r in rows]


# ---------------------------------------------------------------------------
# tests/test_mse_join.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ssb():
    rng = np.random.default_rng(7)
    (lo_schema, lineorder), (date_schema, dates) = make_ssb(rng)
    pair = Pair().add("lineorder", lo_schema, lineorder).add("dates", date_schema, dates)
    return pair, lineorder, dates


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_join_groupby_dim_attr(ssb, strategy):
    """BASELINE config 5: group by a dimension attribute, sum a fact measure."""
    pair, lineorder, dates = ssb
    sql = ("SELECT d_year, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "GROUP BY d_year ORDER BY d_year")
    got = pair.same(f"SET joinStrategy = '{strategy}'; {sql} LIMIT 100")
    assert _ints(got) == _ints(sqlite_rows(lineorder, dates, sql))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_join_filters_both_sides(ssb, strategy):
    pair, lineorder, dates = ssb
    sql = ("SELECT d_year, COUNT(*), SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "WHERE lo_discount BETWEEN 1 AND 3 AND d_month <= 6 GROUP BY d_year ORDER BY d_year")
    got = pair.same(f"SET joinStrategy = '{strategy}'; {sql} LIMIT 100")
    assert _ints(got) == _ints(sqlite_rows(lineorder, dates, sql))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_join_scalar_agg(ssb, strategy):
    pair, lineorder, dates = ssb
    sql = ("SELECT SUM(lo_revenue), COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "WHERE d_year = 1994")
    got = pair.same(f"SET joinStrategy = '{strategy}'; {sql}")
    assert _ints(got) == _ints(sqlite_rows(lineorder, dates, sql))


def test_join_groupby_order_trim_keeps_true_top(ssb):
    """The numGroupsLimit trim ranks by the ORDER BY aggregate: every true
    top group sits at a HIGH d_datekey, so a lowest-key trim keeps the
    wrong groups."""
    _, lineorder, dates = ssb
    od = np.asarray(lineorder["lo_orderdate"])
    skewed = dict(lineorder)
    skewed["lo_revenue"] = np.asarray(lineorder["lo_revenue"]) + (od - od.min()).astype(np.int64) * 1000
    (lo_schema, _), (date_schema, _) = make_ssb(np.random.default_rng(7))
    pair = Pair().add("lineorder", lo_schema, skewed).add("dates", date_schema, dates)
    sql = ("SELECT d_datekey, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "GROUP BY d_datekey ORDER BY SUM(lo_revenue) DESC, d_datekey LIMIT 10")
    got = pair.same("SET numGroupsLimit = 40; " + sql)
    assert _ints(got) == _ints(sqlite_rows(skewed, dates, sql))


def test_join_groupby_mixed_fact_dim(ssb):
    """Group keys from both sides of the join."""
    pair, lineorder, dates = ssb
    sql = ("SELECT lo_region, d_year, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "GROUP BY lo_region, d_year ORDER BY lo_region, d_year")
    got = pair.same(sql + " LIMIT 1000")
    assert _ints(got) == _ints(sqlite_rows(lineorder, dates, sql))


def test_left_join_groupby(ssb):
    pair, lineorder, dates = ssb
    sql = ("SELECT d_year, COUNT(*) FROM lineorder LEFT JOIN dates ON lo_orderdate = d_datekey "
           "GROUP BY d_year ORDER BY d_year NULLS LAST")
    got = pair.same(sql + " LIMIT 100")
    assert _ints(got) == _ints(sqlite_rows(lineorder, dates, sql))
    assert got[-1][0] is None


def test_qualified_refs_and_aliases(ssb):
    pair, lineorder, dates = ssb
    got = pair.same(
        "SELECT d.d_year, SUM(lo.lo_revenue) FROM lineorder lo JOIN dates d ON lo.lo_orderdate = d.d_datekey "
        "WHERE lo.lo_discount > 5 GROUP BY d.d_year ORDER BY d.d_year LIMIT 100")
    want = sqlite_rows(lineorder, dates,
                       "SELECT d_year, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
                       "WHERE lo_discount > 5 GROUP BY d_year ORDER BY d_year")
    assert _ints(got) == _ints(want)


@pytest.mark.parametrize("case", ["unknown_table", "unknown_alias"])
def test_join_error_paths(ssb, case):
    pair, _, _ = ssb
    sql = {
        "unknown_table": "SELECT COUNT(*) FROM lineorder JOIN nope ON lo_orderdate = d_datekey",
        "unknown_alias": ("SELECT x.d_year, COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
                          "GROUP BY x.d_year"),
    }[case]
    pair.raises(sql, JaxJoinPlanError, JoinPlanError)


def test_join_error_max_dup_cap():
    """Many-to-many past the expansion cap (max multiplicity > 64)."""
    rng = np.random.default_rng(0)
    dup = S.Schema(name="dup", fields=[S.FieldSpec("k", S.DataType.INT), S.FieldSpec("v", S.DataType.INT)])
    f = S.Schema(name="f", fields=[S.FieldSpec("fk", S.DataType.INT),
                                   S.FieldSpec("m", S.DataType.INT, role=S.FieldRole.METRIC)])
    pair = Pair().add("dup", dup, {"k": rng.integers(0, 2, 640), "v": np.arange(640)})
    pair.add("f", f, {"fk": rng.integers(0, 2, 64), "m": np.arange(64)})
    pair.raises("SELECT COUNT(*), SUM(m) FROM f JOIN dup ON fk = k", NotImplementedError, NotImplementedError,
                match="joinMaxDup")


def test_singletable_alias_qualifiers(ssb):
    """alias.column on a query with no join resolves in the parser."""
    pair, lineorder, _ = ssb
    got = pair.same("SELECT tt.lo_region, COUNT(*) FROM lineorder tt GROUP BY tt.lo_region "
                    "ORDER BY tt.lo_region LIMIT 10")
    regions, counts = np.unique(np.asarray(lineorder["lo_region"]), return_counts=True)
    assert _ints(got) == list(zip(regions.tolist(), counts.tolist()))
    pair.raises("SELECT nope.lo_region FROM lineorder tt LIMIT 1", JaxSqlParseError, SqlParseError)


def test_bad_join_strategy_rejected(ssb):
    pair, _, _ = ssb
    pair.raises("SET joinStrategy = 'hash'; SELECT COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey",
                ValueError, ValueError, match="joinStrategy")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_join_groupby_long_rawint_beyond_int32(strategy):
    """A LONG metric group column past int32 does not wrap in the group codes."""
    rng = np.random.default_rng(3)
    n, base = 512, 5_000_000_000
    fact_schema = S.Schema(name="f2", fields=[
        S.FieldSpec("fk", S.DataType.INT), S.FieldSpec("bucket", S.DataType.LONG, role=S.FieldRole.METRIC),
        S.FieldSpec("m", S.DataType.INT, role=S.FieldRole.METRIC)])
    fact = {"fk": rng.integers(0, 50, n).astype(np.int64),
            "bucket": (base + rng.integers(0, 4, n)).astype(np.int64),
            "m": rng.integers(0, 100, n).astype(np.int64)}
    dim_schema = S.Schema(name="d2", fields=[S.FieldSpec("dk", S.DataType.INT), S.FieldSpec("grp", S.DataType.INT)])
    dim = {"dk": np.arange(50, dtype=np.int64), "grp": (np.arange(50) % 5).astype(np.int64)}
    pair = Pair().add("f2", fact_schema, fact).add("d2", dim_schema, dim)
    got = pair.same(f"SET joinStrategy = '{strategy}'; SET shuffleSlack = 8; "
                    "SELECT bucket, SUM(m) FROM f2 JOIN d2 ON fk = dk GROUP BY bucket ORDER BY bucket LIMIT 10")
    buckets = np.unique(fact["bucket"])
    assert _ints(got) == [(int(b), int(fact["m"][fact["bucket"] == b].sum())) for b in buckets]


def test_left_join_nullable_dim_attr_null_group():
    """LEFT JOIN group-by on a nullable dim attribute: stored-NULL rows and
    unmatched rows fold into ONE SQL NULL group (the placeholder remap onto
    the null slot past the dictionary)."""
    rng = np.random.default_rng(11)
    n = 256
    fact_schema = S.Schema(name="f3", fields=[S.FieldSpec("fk", S.DataType.INT),
                                              S.FieldSpec("m", S.DataType.INT, role=S.FieldRole.METRIC)])
    fact = {"fk": rng.integers(0, 40, n).astype(np.int64), "m": np.ones(n, dtype=np.int64)}
    dim_schema = S.Schema(name="d3", fields=[S.FieldSpec("dk", S.DataType.INT),
                                             S.FieldSpec("dv", S.DataType.INT, nullable=True)])
    dvals = [None if i % 3 == 0 else (10 if i % 2 else 20) for i in range(30)]  # dks 0..29 only
    dim = {"dk": np.arange(30, dtype=np.int64), "dv": np.array(dvals, dtype=object)}
    pair = Pair().add("f3", fact_schema, fact).add("d3", dim_schema, dim)
    got = pair.same("SELECT dv, COUNT(*) FROM f3 LEFT JOIN d3 ON fk = dk GROUP BY dv ORDER BY dv NULLS LAST LIMIT 10")
    exp = {}
    for fk in fact["fk"]:
        v = dvals[int(fk)] if fk < 30 else None
        exp[v] = exp.get(v, 0) + 1
    assert {r[0]: int(r[1]) for r in got} == exp
    assert sum(r[0] is None for r in got) == 1


def test_shuffle_overflow_retries_to_exact_result(ssb):
    """A tiny slack overflows the buckets; the back-pressure loop re-plans
    with a doubled slack until the exchange fits, and the answer is exact."""
    pair, lineorder, dates = ssb
    sql = ("SELECT d_year, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "GROUP BY d_year ORDER BY d_year")
    mse = pair.port._mse()
    misses = mse.plan_misses
    got = pair.same(f"SET joinStrategy = 'shuffle'; SET shuffleSlack = 0.01; {sql} LIMIT 100")
    assert _ints(got) == _ints(sqlite_rows(lineorder, dates, sql))
    retries = PORT_METRICS.counter("mse.exchangeOverflowRetries").value
    # at one device the cap is 1.0: 0.01 doubles seven times, 0.64 -> 1.0
    assert retries == 7 and JAX_METRICS.counter("mse.exchangeOverflowRetries").value > 0
    # each retry's slack misses the plan cache (8 plans), the rerun hits
    assert mse.plan_misses - misses == 8
    pair.port.query(f"SET joinStrategy = 'shuffle'; SET shuffleSlack = 0.01; {sql} LIMIT 100")
    assert mse.plan_misses - misses == 8 and PORT_METRICS.counter("mse.exchangeOverflowRetries").value == 14


def test_shuffle_overflow_gives_up_at_slack_cap(ssb):
    pair, _, _ = ssb
    pair.raises("SET joinStrategy = 'shuffle'; SET shuffleSlack = 0.01; SET shuffleSlackCap = 0.01; "
                "SELECT d_year, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
                "GROUP BY d_year", RuntimeError, RuntimeError, match="shuffleSlackCap")


# -- bounded many-to-many joins -------------------------------------------
@pytest.fixture(scope="module")
def mn():
    rng = np.random.default_rng(29)
    (os_, orders), (ss, shipments) = _mn_env(rng)
    return Pair().add("orders", os_, orders).add("shipments", ss, shipments), orders, shipments


def test_inner_mn_aggregation(mn):
    """Each fact row contributes once PER matching build row."""
    pair, orders, shipments = mn
    sql = "SELECT COUNT(*), SUM(o_rev) FROM orders JOIN shipments ON o_key = s_key"
    got = pair.same(sql + " LIMIT 10")
    assert _ints(got) == _ints(_mn_sqlite(orders, shipments, sql))


def test_inner_mn_groupby_build_attr(mn):
    pair, orders, shipments = mn
    sql = ("SELECT s_carrier, COUNT(*), SUM(o_rev) FROM orders JOIN shipments ON o_key = s_key "
           "GROUP BY s_carrier ORDER BY s_carrier")
    got = pair.same(sql + " LIMIT 10")
    assert _ints(got) == _ints(_mn_sqlite(orders, shipments, sql))


def test_left_mn_keeps_unmatched(mn):
    pair, orders, shipments = mn
    sql = ("SELECT s_carrier, COUNT(*) FROM orders LEFT JOIN shipments ON o_key = s_key "
           "GROUP BY s_carrier ORDER BY s_carrier")
    got = pair.same(sql + " LIMIT 10", ordered=False)
    assert set(_ints(got)) == set(_ints(_mn_sqlite(orders, shipments, sql)))


def test_mn_with_filters(mn):
    pair, orders, shipments = mn
    sql = ("SELECT COUNT(*), SUM(o_rev) FROM orders JOIN shipments ON o_key = s_key "
           "WHERE o_rev > 500 AND s_carrier = 'ups'")
    got = pair.same(sql + " LIMIT 10")
    assert _ints(got) == _ints(_mn_sqlite(orders, shipments, sql))


def test_shuffle_strategy_rejected_for_mn(mn):
    pair, _, _ = mn
    pair.raises("SET joinStrategy = 'shuffle'; SELECT COUNT(*) FROM orders JOIN shipments ON o_key = s_key LIMIT 5",
                NotImplementedError, NotImplementedError, match="broadcast")


# ---------------------------------------------------------------------------
# tests/test_mse_join_general.py
# ---------------------------------------------------------------------------
N_FACT, N_DATE, N_CITY = 4000, 300, 24


@pytest.fixture(scope="module")
def world():
    """The JAX test's tables (same seed, same draws) in both packages and sqlite."""
    rng = np.random.default_rng(77)
    citykeys = np.arange(N_CITY, dtype=np.int64) + 100
    cities = {"c_citykey": citykeys, "c_region": np.asarray([f"region{i % 5}" for i in range(N_CITY)]),
              "c_pop": rng.integers(1, 1000, N_CITY).astype(np.int64)}
    city_schema = S.Schema("city", [S.FieldSpec("c_citykey", S.DataType.INT),
                                    S.FieldSpec("c_region", S.DataType.STRING),
                                    S.FieldSpec("c_pop", S.DataType.LONG, role=S.FieldRole.METRIC)])
    datekeys = (19920101 + np.arange(N_DATE) * 7).astype(np.int64)
    dates = {"d_datekey": datekeys, "d_year": (1992 + (np.arange(N_DATE) // 53)).astype(np.int64),
             "d_citykey": rng.choice(citykeys, N_DATE).astype(np.int64)}
    date_schema = S.Schema("dates", [S.FieldSpec("d_datekey", S.DataType.INT), S.FieldSpec("d_year", S.DataType.INT),
                                     S.FieldSpec("d_citykey", S.DataType.INT)])
    lineorder = {"lo_orderdate": rng.choice(np.concatenate([datekeys, datekeys[:1] - 99]), N_FACT).astype(np.int64),
                 "lo_revenue": rng.integers(1, 10_000, N_FACT).astype(np.int64),
                 "lo_tag": rng.choice(["a", "b", "c"], N_FACT)}
    lo_schema = S.Schema("lineorder", [S.FieldSpec("lo_orderdate", S.DataType.INT),
                                       S.FieldSpec("lo_revenue", S.DataType.LONG, role=S.FieldRole.METRIC),
                                       S.FieldSpec("lo_tag", S.DataType.STRING)])
    ship = {"s_datekey": np.repeat(datekeys[:64], 3).astype(np.int64),
            "s_mode": np.tile(np.asarray(["air", "sea", "rail"]), 64)}
    ship_schema = S.Schema("ship", [S.FieldSpec("s_datekey", S.DataType.INT), S.FieldSpec("s_mode", S.DataType.STRING)])
    pair = Pair()
    con = sqlite3.connect(":memory:")
    for name, schema, data in (("lineorder", lo_schema, lineorder), ("dates", date_schema, dates),
                               ("city", city_schema, cities), ("ship", ship_schema, ship)):
        pair.add(name, schema, data)
        cols = schema.column_names
        con.execute(f"CREATE TABLE {name} ({', '.join(cols)})")
        con.executemany(f"INSERT INTO {name} VALUES ({','.join('?' * len(cols))})",
                        list(zip(*(np.asarray(data[c]).tolist() for c in cols))))
    yield pair, con
    con.close()


def test_inner_selection_vs_sqlite(world):
    pair, con = world
    sql = ("SELECT d_year, lo_revenue FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "WHERE lo_revenue > 9000 ORDER BY lo_revenue, d_year LIMIT 25")
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())


def test_left_join_selection_null_dims(world):
    pair, con = world
    sql = ("SELECT lo_orderdate, d_year FROM lineorder LEFT JOIN dates ON lo_orderdate = d_datekey "
           "ORDER BY lo_orderdate LIMIT 30")
    got = pair.same(sql)
    want = con.execute(sql).fetchall()
    assert [int(r[0]) for r in got] == [r[0] for r in want]
    assert [r[1] is None for r in got] == [r[1] is None for r in want]
    assert any(r[1] is None for r in got)


def test_string_and_fact_columns(world):
    pair, con = world
    sql = ("SELECT lo_tag, d_year FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "WHERE d_year = 1993 ORDER BY lo_tag, d_year LIMIT 20")
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())


def test_mn_join_selection(world):
    pair, con = world
    sql = ("SELECT lo_revenue, s_mode FROM lineorder JOIN ship ON lo_orderdate = s_datekey "
           "WHERE lo_revenue > 9500 ORDER BY lo_revenue, s_mode LIMIT 30")
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())


def test_numeric_looking_strings_sort_lexicographically():
    """The ORDER BY pre-trim ranks numeric-looking strings like the final
    comparator (lexicographically), not numerically."""
    n = 64
    tags = np.asarray([str(v) for v in ([2, 9, 10, 100] * (n // 4))])
    keys = np.arange(n, dtype=np.int64) % 8
    pair = Pair().add("f", S.Schema("f", [S.FieldSpec("f_tag", S.DataType.STRING), S.FieldSpec("f_k", S.DataType.INT)]),
                      {"f_tag": tags, "f_k": keys})
    pair.add("d", S.Schema("d", [S.FieldSpec("d_k", S.DataType.INT), S.FieldSpec("d_v", S.DataType.INT)]),
             {"d_k": np.arange(8, dtype=np.int64), "d_v": np.arange(8, dtype=np.int64) * 2})
    con = sqlite3.connect(":memory:")
    con.execute("CREATE TABLE f (f_tag, f_k)")
    con.execute("CREATE TABLE d (d_k, d_v)")
    con.executemany("INSERT INTO f VALUES (?,?)", list(zip(tags.tolist(), keys.tolist())))
    con.executemany("INSERT INTO d VALUES (?,?)", [(i, i * 2) for i in range(8)])
    sql = "SELECT f_tag, d_v FROM f JOIN d ON f_k = d_k ORDER BY f_tag, d_v LIMIT 5"
    got = pair.same(sql)
    assert _ints(got) == _ints(con.execute(sql).fetchall())
    assert got[0][0] == "10"


def test_chain_groupby(world):
    pair, con = world
    sql = ("SELECT c_region, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "JOIN city ON d_citykey = c_citykey GROUP BY c_region ORDER BY c_region")
    assert _ints(pair.same(sql + " LIMIT 20")) == _ints(con.execute(sql).fetchall())


def test_chain_selection(world):
    pair, con = world
    sql = ("SELECT c_region, lo_revenue FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "JOIN city ON d_citykey = c_citykey WHERE lo_revenue > 9200 ORDER BY lo_revenue, c_region LIMIT 25")
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())


def test_chain_aggregation_count(world):
    pair, con = world
    sql = ("SELECT COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "JOIN city ON d_citykey = c_citykey WHERE c_pop > 500")
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())


def test_chain_left_parent_semantics(world):
    """An unmatched LEFT parent row does not match the chained dimension."""
    pair, con = world
    sql = ("SELECT lo_orderdate, c_region FROM lineorder LEFT JOIN dates ON lo_orderdate = d_datekey "
           "LEFT JOIN city ON d_citykey = c_citykey ORDER BY lo_orderdate LIMIT 30")
    got = pair.same(sql)
    want = con.execute(sql).fetchall()
    assert [int(r[0]) for r in got] == [r[0] for r in want]
    assert [r[1] is None for r in got] == [r[1] is None for r in want]


def test_self_join_aggregation(world):
    pair, con = world
    sql = "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder JOIN dates d1 ON lo_orderdate = d1.d_datekey"
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())


def test_self_join_two_instances(world):
    pair, con = world
    sql = ("SELECT COUNT(*) FROM lineorder JOIN dates d1 ON lo_orderdate = d1.d_datekey "
           "JOIN dates d2 ON d1.d_datekey = d2.d_datekey WHERE d2.d_year = 1993")
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())
    # both aliases read the one table through facades
    assert {"dates@d1", "dates@d2"} <= set(pair.port.tables)


def test_self_join_selection(world):
    pair, con = world
    sql = ("SELECT d1.d_year, d2.d_citykey, lo_revenue FROM lineorder "
           "JOIN dates d1 ON lo_orderdate = d1.d_datekey JOIN dates d2 ON d1.d_datekey = d2.d_datekey "
           "WHERE lo_revenue > 9500 ORDER BY lo_revenue, d1.d_year, d2.d_citykey LIMIT 15")
    assert _ints(pair.same(sql)) == _ints(con.execute(sql).fetchall())


def test_self_join_requires_alias(world):
    pair, _ = world
    pair.raises("SELECT COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
                "JOIN dates ON lo_orderdate = d_datekey", JaxJoinPlanError, JoinPlanError)


def test_three_level_chain(world):
    pair, con = world
    sql = ("SELECT d_year, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "JOIN city ON d_citykey = c_citykey WHERE c_region = 'region2' GROUP BY d_year ORDER BY d_year")
    assert _ints(pair.same(sql + " LIMIT 20")) == _ints(con.execute(sql).fetchall())


@pytest.mark.parametrize("sql,match", [
    ("SET joinStrategy = 'shuffle'; SELECT COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
     "JOIN city ON d_citykey = c_citykey", "multi-join"),
    ("SELECT lo_revenue FROM lineorder JOIN dates ON lo_orderdate = d_datekey WHERE lo_revenue > 9000 OR d_year = 1993 "
     "LIMIT 3",
     "cross-table"),
    ("SELECT * FROM lineorder JOIN dates ON lo_orderdate = d_datekey LIMIT 3", "SELECT \\*"),
    ("SELECT COUNT(*) FROM lineorder LEFT JOIN dates ON lo_orderdate = d_datekey WHERE d_year = 1993",
     "LEFT JOIN dimension"),
    ("SELECT d_year, SUM(d_citykey) FROM lineorder JOIN dates ON lo_orderdate = d_datekey GROUP BY d_year",
     "fact-table measures"),
    ("SELECT COUNT(*) FROM lineorder JOIN ship ON lo_orderdate = s_datekey JOIN dates ON lo_orderdate = d_datekey "
     "JOIN city ON s_datekey = c_citykey", "many-to-many"),
])
def test_join_refusals_match_jax(world, sql, match):
    """What the engine refuses, it refuses with the JAX engine's type."""
    pair, _ = world
    with pytest.raises((JaxJoinPlanError, NotImplementedError), match=match) as jerr:
        pair.jax.query(sql)
    with pytest.raises((JoinPlanError, NotImplementedError), match=match) as perr:
        pair.port.query(sql)
    assert isinstance(perr.value, NotImplementedError) == isinstance(jerr.value, NotImplementedError)


# ---------------------------------------------------------------------------
# tests/test_index_filters.py::test_mse_join_with_indexed_fact_filter
# ---------------------------------------------------------------------------
def test_mse_join_with_indexed_fact_filter():
    """A join's fact-side filter rides the inverted index too."""
    rng = np.random.default_rng(22)
    n = 5000
    data = {"city": rng.choice(["sf", "nyc", "la", "sea", "aus"], n).astype(object),
            "year": rng.integers(2000, 2020, n).astype(np.int32),
            "day": np.sort(rng.integers(0, 366, n).astype(np.int32)),
            "v": rng.integers(0, 100_000, n)}
    schema = S.Schema("indexed", [S.FieldSpec("city", S.DataType.STRING), S.FieldSpec("year", S.DataType.INT),
                                  S.FieldSpec("day", S.DataType.INT),
                                  S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC)])

    def config(C):
        return C.TableConfig("indexed", indexing=C.IndexingConfig(
            inverted_index_columns=["city"], range_index_columns=["year"], sorted_column="day"))

    years = S.Schema("years", [S.FieldSpec("y", S.DataType.INT), S.FieldSpec("decade", S.DataType.INT)])
    pair = Pair().add("indexed", schema, data, config)
    pair.add("years", years, {"y": np.arange(2000, 2020, dtype=np.int32),
                              "decade": (np.arange(2000, 2020) // 10).astype(np.int32)})
    sql = ("SELECT decade, COUNT(*) FROM indexed JOIN years ON year = y WHERE city = 'sf' "
           "GROUP BY decade ORDER BY decade LIMIT 10")
    got = pair.same(sql)
    res = pair.port.query(sql)
    assert ("city", "inverted") in res.stats.filter_index_uses
    assert res.stats.filter_index_uses == pair.jax.query(sql).stats.filter_index_uses
    assert sum(int(r[1]) for r in got) == int((data["city"] == "sf").sum())


# ---------------------------------------------------------------------------
# port-only cases: strings, NULL keys, the backend tag, the ledger
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def keyed():
    """A fact table with a STRING key and a nullable INT key against two
    dimensions: string keys whose dictionaries differ (values missing on
    either side), and a nullable build key."""
    rng = np.random.default_rng(31)
    n = 3000
    fk = rng.integers(0, 40, n).astype(object)
    fk[rng.random(n) < 0.1] = None
    fact = {"f_city": rng.choice(["ams", "ber", "cai", "del", "osl"], n).astype(object), "f_k": fk,
            "f_m": rng.integers(0, 1000, n).astype(np.int64)}
    fact_schema = S.Schema("fact", [S.FieldSpec("f_city", S.DataType.STRING),
                                    S.FieldSpec("f_k", S.DataType.INT, nullable=True),
                                    S.FieldSpec("f_m", S.DataType.LONG, role=S.FieldRole.METRIC)])
    city = {"c_name": np.asarray(["ams", "ber", "cai", "lim", "rio"], dtype=object),
            "c_zone": np.asarray(["eu", "eu", "af", "sa", "sa"], dtype=object)}
    city_schema = S.Schema("cities", [S.FieldSpec("c_name", S.DataType.STRING), S.FieldSpec("c_zone", S.DataType.STRING)])
    dk = np.arange(30).astype(object)
    dk[[3, 7]] = None
    kdim = {"k_key": dk, "k_band": (np.arange(30) % 4).astype(np.int64)}
    kdim_schema = S.Schema("kdim", [S.FieldSpec("k_key", S.DataType.INT, nullable=True),
                                    S.FieldSpec("k_band", S.DataType.INT)])
    pair = Pair().add("fact", fact_schema, fact).add("cities", city_schema, city).add("kdim", kdim_schema, kdim)
    return pair, fact, city, kdim


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_string_join_keys_translate_through_dictionaries(keyed, strategy):
    pair, fact, city, _ = keyed
    got = pair.same(f"SET joinStrategy = '{strategy}'; SELECT c_zone, COUNT(*), SUM(f_m) FROM fact "
                    "JOIN cities ON f_city = c_name GROUP BY c_zone ORDER BY c_zone")
    zone = dict(zip(city["c_name"], city["c_zone"]))
    exp = {}
    for c, m in zip(fact["f_city"], fact["f_m"]):
        if c in zone:
            cnt, s = exp.get(zone[c], (0, 0))
            exp[zone[c]] = (cnt + 1, s + int(m))
    assert _ints(got) == [(z, c, s) for z, (c, s) in sorted(exp.items())]


@pytest.mark.parametrize("join", ["JOIN", "LEFT JOIN"])
def test_null_keys_never_match(keyed, join):
    """A NULL key is the sentinel on both sides: a NULL fact key matches no
    row, a NULL build key is matched by none (LEFT keeps the fact row)."""
    pair, fact, _, kdim = keyed
    got = pair.same(f"SELECT k_band, COUNT(*) FROM fact {join} kdim ON f_k = k_key GROUP BY k_band "
                    "ORDER BY k_band NULLS LAST")
    band = {int(k): int(b) for k, b in zip(kdim["k_key"], kdim["k_band"]) if k is not None}
    exp = {}
    for k in fact["f_k"]:
        b = band.get(int(k)) if k is not None else None
        if b is None and join == "JOIN":
            continue
        exp[b] = exp.get(b, 0) + 1
    assert {r[0]: r[1] for r in got} == exp


def test_left_join_null_slot_past_dictionary(keyed):
    """The LEFT JOIN's NULL group is a slot past the dictionary: the group
    dimension's cardinality grows by one and its null code is that slot."""
    pair, _, city, _ = keyed
    sql = "SELECT c_zone, COUNT(*) FROM fact LEFT JOIN cities ON f_city = c_name GROUP BY c_zone"
    got = pair.same(sql, ordered=False)
    assert any(r[0] is None for r in got)
    from pinot_tpu_torch.sql.parser import parse_query

    plan = pair.port._mse()._plan(parse_query(sql))
    (gd,) = plan.group_dims
    card = len(np.unique(city["c_zone"]))
    assert (gd.kind, gd.cardinality, gd.null_code) == ("dict", card + 1, card)


def test_join_groupby_plans_with_the_backend_tag(keyed, monkeypatch):
    """A dense join group-by plans with planner.backend_tag: "torch" on the
    CPU, and "cuda" (which sends the int32 key to the fused-scan kernel's
    wrapper) on a card."""
    from pinot_tpu_torch.ops import fused_scan

    pair, _, _, _ = keyed
    sql = "SELECT c_zone, COUNT(*), SUM(f_m) FROM fact JOIN cities ON f_city = c_name GROUP BY c_zone"
    seen, calls = [], []
    real_gp, real_scan = port_planner.grouped_partials, fused_scan.fused_group_tables

    def spy_gp(*a, **kw):
        seen.append(kw.get("backend"))
        return real_gp(*a, **kw)

    def spy_scan(entries, codes, num_groups, **kw):
        calls.append((codes.dtype, num_groups, [e[0] for e in entries]))
        return real_scan(entries, codes, num_groups, **kw)

    monkeypatch.setattr(port_planner, "grouped_partials", spy_gp)
    monkeypatch.setattr(fused_scan, "fused_group_tables", spy_scan)
    want = pair.same(sql, ordered=False)
    assert seen == ["torch"] and calls == []
    # the same engine on a card: a "cuda" plan (a new plan-cache key)
    monkeypatch.setattr(port_planner, "backend_tag", lambda dev: "cuda")
    assert_same_rows(pair.port.query(sql).rows, want)
    assert seen == ["torch", "cuda"]
    # one scan: the computed int32 key over the 3 zones, the shared
    # presence / COUNT(*) entry and the integer sum
    assert calls == [(torch.int32, 3, ["count", "int_sum"])]


def test_ledger_records_mse_queries(ssb):
    pair, _, _ = ssb
    sql = "SELECT d_year, COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey GROUP BY d_year"
    first = pair.port.query(sql)
    res = pair.port.query(sql)
    assert res.stats.kernel_bytes == first.stats.kernel_bytes > 0
    assert res.stats.kernel_cost_source == "analytic"
    assert first.stats.compile_ms > 0 and res.stats.compile_ms == 0  # planned once, then a cache hit
    (shape,) = PORT_LEDGER.snapshot()["tables"]["lineorder"]["shapes"].values()
    assert shape["queries"] == 2 and shape["planCacheHitRate"] == 0.5


def test_segment_engine_refuses_joins_with_the_jax_message():
    eng = PortEngine(device="cpu")
    from pinot_tpu_torch.sql.parser import parse_query

    with pytest.raises(NotImplementedError, match="require the distributed engine"):
        eng.execute(parse_query("SELECT COUNT(*) FROM a JOIN b ON x = y"))


def test_multistage_engine_standalone_and_facades(ssb):
    """MultiStageEngine alone over a table registry; re-registering a table
    drops its stale self-join facades."""
    _, lineorder, dates = ssb
    (lo_schema, _), (date_schema, _) = make_ssb(np.random.default_rng(7))
    mse = MultiStageEngine(device="cpu")
    lo = PortStacked.build(port_schema.Schema.from_dict(lo_schema.to_dict()), dict(lineorder), SHARDS)
    dt = PortStacked.build(port_schema.Schema.from_dict(date_schema.to_dict()), dict(dates), SHARDS)
    mse.register_table("lineorder", lo)
    mse.register_table("dates", dt)
    sql = ("SELECT COUNT(*) FROM lineorder JOIN dates d1 ON lo_orderdate = d1.d_datekey "
           "JOIN dates d2 ON d1.d_datekey = d2.d_datekey")
    n = mse.query(sql).rows[0][0]
    assert n == _ints(sqlite_rows(lineorder, dates, "SELECT COUNT(*) FROM lineorder JOIN dates "
                                                    "ON lo_orderdate = d_datekey"))[0][0]
    assert "dates@d1" in mse.tables
    mse.register_table("dates", dt)
    assert not any(k.startswith("dates@") for k in mse.tables)


def test_mse_runs_on_cuda_unless_told(monkeypatch):
    """MultiStageEngine() means CUDA and raises without it; the distributed
    engine's join engine shares its device, tables and residency manager."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStageEngine()
    dist = PortDist(device="cpu", hbm_cache_bytes=1 << 20)
    mse = dist._mse()
    assert mse.device.type == "cpu" and mse.tables is dist.tables and mse.residency is dist.residency
    assert dist._mse() is mse
