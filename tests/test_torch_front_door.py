"""The port's single-engine front door against the JAX package's.

The same numpy data (made from seeds) goes through the JAX QueryEngine and
the port's QueryEngine(device="cpu"), and, for GAPFILL and the trace spans,
through both DistributedEngines over a one-shard StackedTable (the JAX side
on its interpret-mode Pallas scan, PINOT_TPU_SCAN_BACKEND=interpret):

- GAPFILL: every case of tests/test_gapfill.py (hand-computed goldens) on
  both packages and both port engines;
- set operations and IN / NOT IN (SELECT ...): the cases of
  tests/test_sql_breadth.py, INTERSECT binding tighter, EXPLAIN over a set
  operation as one plan;
- EXPLAIN rows equal to the JAX package's; EXPLAIN ANALYZE's operator rows,
  Rows and Bytes (the analytic byte model) equal, costSource "analytic";
- trace spans (names and counts) and the safety rails of
  tests/test_safety.py: deadlines, admission with estimate_segment_bytes
  equal across the packages, the workload scheduler, env layering;
- the slow-query log, DDL (equal SHOW CREATE TABLE strings), ResponseStore;
- the port's DistributedEngine refusing set operations, IN (SELECT ...) and
  EXPLAIN, beside what the JAX engine does with each.

Tolerance: every result here is integer-valued or a string, so rows compare
exactly, value and Python type (floats of integer sums included).
"""
import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu import ops as jax_ops
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.query import cursors as jax_cursors
from pinot_tpu.query import safety as jax_safety
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.query.result import ResultTable as JaxResultTable
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import env as jax_env
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.sql import ddl as jax_ddl
from pinot_tpu.sql.parser import parse_query as jax_parse
from pinot_tpu.utils.slowlog import SlowQueryLog as JaxSlowLog

from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.query import analyze as port_analyze
from pinot_tpu_torch.query import cursors as port_cursors
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query import safety as port_safety
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.query.result import ResultTable as PortResultTable
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import env as port_env
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql import ddl as port_ddl
from pinot_tpu_torch.sql.parser import parse_query as port_parse
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS
from pinot_tpu_torch.utils.metrics import Trace as PortTrace
from pinot_tpu_torch.utils.perf import PERF_LEDGER as PORT_LEDGER
from pinot_tpu_torch.utils.slowlog import SlowQueryLog as PortSlowLog

from test_torch_sketches import assert_same_rows


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    PORT_METRICS.reset()
    PORT_LEDGER.reset()
    yield


@pytest.fixture(autouse=True)
def _interpret_scan(monkeypatch):
    """The JAX side on its Pallas scan in interpret mode, as the JAX
    package's own distributed tests run it on the CPU."""
    monkeypatch.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
    jax_ops.scan_backend.cache_clear()
    yield
    jax_ops.scan_backend.cache_clear()


def _pair(make_schema, datas, config=None, **engine_kw):
    """(JAX QueryEngine, port QueryEngine(device="cpu")) over the same data,
    one segment per element of `datas`."""
    je, pe = JaxEngine(**engine_kw), PortEngine(device="cpu", **engine_kw)
    for eng, S, C, build in ((je, jax_schema, jax_config, jax_build), (pe, port_schema, port_config, port_build)):
        schema = make_schema(S)
        cfg = config(C) if config is not None else None
        eng.register_table(schema, cfg)
        for i, d in enumerate(datas):
            kw = {"table_config": cfg} if cfg is not None else {}
            eng.add_segment(schema.name, build(schema, dict(d), f"s{i}", **kw))
    return je, pe


def _dist_pair(make_schema, data, config=None):
    """(JAX DistributedEngine on a one-device mesh, port DistributedEngine)
    over one-shard StackedTables of the same data."""
    js = JaxStacked.build(make_schema(jax_schema), dict(data), num_shards=1,
                          table_config=config(jax_config) if config else None)
    ps = PortStacked.build(make_schema(port_schema), dict(data), num_shards=1,
                           table_config=config(port_config) if config else None)
    je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1))
    pe = PortDist(device="cpu", hbm_cache_bytes=0)
    name = make_schema(port_schema).name
    je.register_table(name, js)
    pe.register_table(name, ps)
    return je, pe


# ---------------------------------------------------------------------------
# GAPFILL (tests/test_gapfill.py's table and goldens)
# ---------------------------------------------------------------------------
def _gf_schema(S):
    return S.Schema("ts", [
        S.FieldSpec("bucket", S.DataType.LONG),
        S.FieldSpec("device", S.DataType.STRING),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
    ])


GF_DATA = {
    "bucket": np.array([100, 100, 120, 130, 110, 130, 90, 200], np.int64),
    "device": np.array(["a", "a", "a", "a", "b", "b", "a", "b"], object),
    "v": np.array([1, 2, 5, 7, 4, 6, 99, 99], np.int64),
}

GAPFILL_CASES = {
    "default_null_fill": (
        "SELECT GAPFILL(bucket, 100, 140, 10), SUM(v) FROM ts WHERE device = 'a' GROUP BY bucket LIMIT 100",
        [(100, 3), (110, None), (120, 5), (130, 7)],
    ),
    "previous_value": (
        "SELECT GAPFILL(bucket, 100, 140, 10, FILL(SUM(v), 'FILL_PREVIOUS_VALUE')), "
        "SUM(v) FROM ts WHERE device = 'a' GROUP BY bucket LIMIT 100",
        [(100, 3), (110, 3), (120, 5), (130, 7)],
    ),
    "timeserieson": (
        "SELECT GAPFILL(bucket, 100, 140, 10, FILL(SUM(v), 'FILL_PREVIOUS_VALUE'), "
        "TIMESERIESON(device)), device, SUM(v) FROM ts "
        "GROUP BY bucket, device ORDER BY device, bucket LIMIT 100",
        [(100, "a", 3), (110, "a", 3), (120, "a", 5), (130, "a", 7),
         (100, "b", None), (110, "b", 4), (120, "b", 4), (130, "b", 6)],
    ),
    "alias_fill_target": (
        "SELECT GAPFILL(bucket, 100, 140, 10, FILL(s, 'FILL_PREVIOUS_VALUE')), "
        "SUM(v) AS s, COUNT(*) FROM ts WHERE device = 'a' GROUP BY bucket LIMIT 100",
        [(100, 3, 2), (110, 3, None), (120, 5, 1), (130, 7, 1)],
    ),
    "default_value_fill": (
        "SELECT GAPFILL(bucket, 100, 140, 10, FILL(SUM(v), 'FILL_DEFAULT_VALUE')), "
        "SUM(v) FROM ts WHERE device = 'a' GROUP BY bucket LIMIT 100",
        [(100, 3), (110, 0), (120, 5), (130, 7)],
    ),
    "order_by_desc": (
        "SELECT GAPFILL(bucket, 100, 140, 10), SUM(v) FROM ts "
        "WHERE device = 'a' GROUP BY bucket ORDER BY bucket DESC LIMIT 2",
        [(130, 7), (120, 5)],
    ),
}


@pytest.fixture(scope="module")
def gf_engines():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
        jax_ops.scan_backend.cache_clear()
        je, pe = _pair(_gf_schema, [GF_DATA])
        jd, pd = _dist_pair(_gf_schema, GF_DATA)
    return je, pe, jd, pd


def _typed(rows):
    """Rows with integer-valued floats as ints (the goldens are hand-written)."""
    return [tuple(int(c) if isinstance(c, float) and c.is_integer() else c for c in r) for r in rows]


@pytest.mark.parametrize("case", sorted(GAPFILL_CASES))
def test_gapfill_matches_jax(gf_engines, case):
    sql, want = GAPFILL_CASES[case]
    je, pe, jd, pd = gf_engines
    jrows = je.query(sql).rows
    assert _typed(jrows) == want
    assert_same_rows(pe.query(sql).rows, jrows, ordered=True)
    # the distributed engines fill through the shared reduce
    jdrows = jd.query(sql).rows
    assert _typed(jdrows) == want
    assert_same_rows(pd.query(sql).rows, jdrows, ordered=True)


def test_gapfill_out_of_range_rows_dropped(gf_engines):
    sql = GAPFILL_CASES["previous_value"][0]
    je, pe, jd, pd = gf_engines
    for eng in (pe, pd):
        rows = eng.query(sql).rows
        assert [r[0] for r in rows] == [100, 110, 120, 130]
        assert all(r[1] != 99 for r in rows)


def test_gapfill_parse_errors():
    from pinot_tpu_torch.sql.parser import SqlParseError

    for sql, match in (
        ("SELECT GAPFILL(b, 0, 10, 0), SUM(v) FROM t GROUP BY b", "step must be positive"),
        ("SELECT GAPFILL(b, 0, 10, 1, FILL(SUM(v), 'FILL_SIDEWAYS')), SUM(v) FROM t GROUP BY b", "FILL mode"),
        ("SELECT GAPFILL(b, 0, 10), SUM(v) FROM t GROUP BY b", "GAPFILL requires"),
    ):
        with pytest.raises(Exception, match=match):
            jax_parse(sql)
        with pytest.raises(SqlParseError, match=match):
            port_parse(sql)


def test_gapfill_unselected_fill_target_errors(gf_engines):
    sql = ("SELECT GAPFILL(bucket, 100, 140, 10, FILL(MAX(v), 'FILL_PREVIOUS_VALUE')), "
           "SUM(v) FROM ts GROUP BY bucket LIMIT 10")
    je, pe, _jd, pd = gf_engines
    with pytest.raises(Exception, match="not in the select list"):
        je.query(sql)
    for eng in (pe, pd):
        with pytest.raises(ValueError, match="not in the select list"):
            eng.query(sql)


# ---------------------------------------------------------------------------
# set operations and IN (SELECT ...) (tests/test_sql_breadth.py's table)
# ---------------------------------------------------------------------------
N_BREADTH = 4000


def _breadth_schema(S):
    return S.Schema("t", [
        S.FieldSpec("city", S.DataType.STRING),
        S.FieldSpec("dept", S.DataType.STRING),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
        S.FieldSpec("score", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
    ])


@pytest.fixture(scope="module")
def breadth():
    rng = np.random.default_rng(53)
    data = {
        "city": rng.choice(["sf", "nyc", "la"], N_BREADTH).astype(object),
        "dept": rng.choice(["eng", "ops", "biz", "hr"], N_BREADTH).astype(object),
        "v": rng.integers(0, 10_000, N_BREADTH),
        "score": np.round(rng.random(N_BREADTH) * 100, 3),
    }
    parts = [{k: a[sl] for k, a in data.items()} for sl in (slice(0, N_BREADTH // 2), slice(N_BREADTH // 2, None))]
    return _pair(_breadth_schema, parts)


BREADTH_CASES = {
    "union_all": "SELECT city FROM t WHERE v > 9990 LIMIT 100 UNION ALL SELECT city FROM t WHERE v < 10 LIMIT 100",
    "union_dedupes": "SELECT city, dept FROM t WHERE v > 5000 LIMIT 100000 UNION "
                     "SELECT city, dept FROM t WHERE v <= 5000 LIMIT 100000",
    "intersect": "SELECT city FROM t WHERE dept = 'eng' LIMIT 100000 INTERSECT "
                 "SELECT city FROM t WHERE dept = 'hr' LIMIT 100000",
    "except": "SELECT dept FROM t WHERE city = 'sf' LIMIT 100000 EXCEPT SELECT dept FROM t WHERE v > 9999 LIMIT 100000",
    "intersect_binds_tighter": "SELECT dept FROM t WHERE city = 'sf' LIMIT 100000 "
                               "UNION SELECT dept FROM t WHERE city = 'nyc' LIMIT 100000 "
                               "INTERSECT SELECT dept FROM t WHERE v > 9995 LIMIT 100000",
    "group_by_union": "SELECT city, COUNT(*), SUM(v) FROM t WHERE v > 5000 GROUP BY city UNION "
                      "SELECT city, COUNT(*), SUM(v) FROM t WHERE dept = 'hr' GROUP BY city",
    "group_by_except": "SELECT dept, city FROM t WHERE v > 9000 GROUP BY dept, city EXCEPT "
                       "SELECT dept, city FROM t WHERE score > 99 GROUP BY dept, city",
    "in_subquery": "SELECT COUNT(*) FROM t WHERE dept IN (SELECT dept FROM t WHERE score > 99.8)",
    "not_in_subquery": "SELECT COUNT(*) FROM t WHERE city NOT IN (SELECT city FROM t WHERE score > 99.97)",
    "empty_subquery": "SELECT COUNT(*) FROM t WHERE dept IN (SELECT dept FROM t WHERE v > 10000000)",
    "grouped_subquery": "SELECT dept, SUM(v) FROM t WHERE city IN (SELECT city FROM t WHERE v > 9000 "
                        "GROUP BY city ORDER BY SUM(v) DESC LIMIT 2) GROUP BY dept ORDER BY dept",
}


@pytest.mark.parametrize("case", sorted(BREADTH_CASES))
def test_set_ops_and_subqueries_match_jax(breadth, case):
    je, pe = breadth
    sql = BREADTH_CASES[case]
    assert_same_rows(pe.query(sql).rows, je.query(sql).rows, ordered=True)


def test_intersect_binds_tighter_than_union_shape():
    ctx = port_parse(BREADTH_CASES["intersect_binds_tighter"])
    assert [op for op, _all, _c in ctx.set_ops] == ["union"]
    assert [op for op, _all, _c in ctx.set_ops[0][2].set_ops] == ["intersect"]


def test_explain_with_set_ops_is_one_plan(breadth):
    je, pe = breadth
    sql = "EXPLAIN PLAN FOR SELECT city FROM t WHERE v > 10 LIMIT 5 UNION SELECT city FROM t LIMIT 5"
    res = pe.query(sql)
    assert res.columns == ["Operator", "Operator_Id", "Parent_Id"]
    ids = [r[1] for r in res.rows]
    assert len(ids) == len(set(ids))
    assert res.rows == je.query(sql).rows


# ---------------------------------------------------------------------------
# EXPLAIN, EXPLAIN ANALYZE, trace spans and the safety rails
# (tests/test_safety.py's table)
# ---------------------------------------------------------------------------
def _safety_schema(S):
    return S.Schema("t", [S.FieldSpec("city", S.DataType.STRING),
                          S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC)])


def _safety_config(C):
    return C.TableConfig(name="t", indexing=C.IndexingConfig(inverted_index_columns=["city"]))


def _safety_pair(budget=8 << 30, n=5000, segments=3, **kw):
    rng = np.random.default_rng(61)
    datas = [{"city": rng.choice(["sf", "nyc"], n).astype(object), "v": rng.integers(0, 100, n)}
             for _ in range(segments)]
    return _pair(_safety_schema, datas, config=_safety_config, memory_budget_bytes=budget, **kw)


@pytest.fixture(scope="module")
def safety():
    return _safety_pair()


EXPLAIN_QUERIES = [
    "SELECT city, SUM(v) FROM t WHERE city = 'sf' GROUP BY city",
    "SELECT COUNT(*) FROM t",
    "SELECT SUM(v), MAX(v) FROM t WHERE v > 50",
    "SELECT city, v FROM t WHERE v < 3 ORDER BY v LIMIT 5",
    "SELECT v, COUNT(*) FROM t GROUP BY v ORDER BY COUNT(*) DESC LIMIT 3",
    "SELECT MOD(v, 7), COUNT(*) FROM t WHERE city <> 'nyc' GROUP BY MOD(v, 7)",
]


@pytest.mark.parametrize("sql", EXPLAIN_QUERIES)
def test_explain_rows_match_jax(safety, sql):
    je, pe = safety
    got = pe.query("EXPLAIN PLAN FOR " + sql)
    assert got.columns == ["Operator", "Operator_Id", "Parent_Id"]
    assert got.rows == je.query("EXPLAIN PLAN FOR " + sql).rows


def test_explain_groupby_with_index(safety):
    _je, pe = safety
    res = pe.query("EXPLAIN PLAN FOR SELECT city, SUM(v) FROM t WHERE city = 'sf' GROUP BY city")
    ops = [r[0] for r in res.rows]
    assert any(o.startswith("BROKER_REDUCE") for o in ops)
    assert any(o.startswith("GROUP_BY") for o in ops)
    assert any("FILTER" in o for o in ops)
    ids = {r[1] for r in res.rows}
    assert all(r[2] in ids | {0} for r in res.rows)


def test_explain_runs_nothing(safety, monkeypatch):
    _je, pe = safety
    from pinot_tpu_torch.query import executor

    def no_launch(*a, **k):
        raise AssertionError("EXPLAIN launched a segment")

    monkeypatch.setattr(executor, "launch_segment", no_launch)
    pe.query("EXPLAIN PLAN FOR SELECT COUNT(*) FROM t")
    assert PORT_METRICS.snapshot()["counters"].get("docsScanned", 0) == 0


def test_explain_of_a_subquery_faults_as_in_jax(safety):
    """EXPLAIN runs no subquery, so the planner meets the unresolved
    IN (SELECT ...) marker: both packages fault the same way (ROADMAP
    Queue 3)."""
    je, pe = safety
    sql = "EXPLAIN PLAN FOR SELECT COUNT(*) FROM t WHERE city IN (SELECT city FROM t)"
    with pytest.raises(TypeError, match="not supported between instances of 'Subquery'"):
        je.query(sql)
    with pytest.raises(TypeError, match="not supported between instances of 'Subquery'"):
        pe.query(sql)


def _span_label(label: str) -> str:
    return label.split(" [", 1)[0]


@pytest.mark.parametrize("sql", EXPLAIN_QUERIES[:3] + EXPLAIN_QUERIES[4:])
def test_explain_analyze_matches_jax(safety, sql):
    je, pe = safety
    jres, pres = je.query("EXPLAIN ANALYZE " + sql), pe.query("EXPLAIN ANALYZE " + sql)
    assert pres.columns == port_analyze.ANALYZE_COLUMNS == list(jres.columns)
    # the operator rows: names, ids, parents, Rows and the analytic Bytes
    n_static = len(je.query("EXPLAIN PLAN FOR " + sql).rows)
    for jr, pr in zip(jres.rows[:n_static], pres.rows[:n_static]):
        assert (pr[0], pr[1], pr[2], pr[4], pr[5]) == (jr[0], jr[1], jr[2], jr[4], jr[5])
    # the trace rows: the same spans under the same parents
    assert [(_span_label(r[0]), r[1], r[2]) for r in pres.rows[n_static:]] == \
        [(_span_label(r[0]), r[1], r[2]) for r in jres.rows[n_static:]]
    launches = [r for r in pres.rows if r[0].startswith("TRACE(launch:")]
    assert len(launches) == 3 and all("costSource=analytic" in r[0] for r in launches)
    assert [r[5] for r in launches] == [r[5] for r in jres.rows if r[0].startswith("TRACE(launch:")]
    assert pres.stats.kernel_cost_source == "analytic"
    assert all(r[7] is None or 0 <= r[7] for r in pres.rows)


def test_trace_spans_match_jax(safety):
    je, pe = safety
    sql = "SET trace = true; SELECT city, COUNT(*) FROM t GROUP BY city"
    jtr, ptr = je.query(sql).stats.trace, pe.query(sql).stats.trace
    assert ptr is not None and ptr["name"] == "query"
    names = [c["name"] for c in ptr["children"]]
    assert names == [c["name"] for c in jtr["children"]]
    assert "reduce" in names and names.count("device_wait") == 1
    assert sum(1 for n in names if n.startswith("launch:")) == 3
    assert sum(1 for n in names if n == "collect") == 3
    assert all(c["ms"] >= 0 for c in ptr["children"])
    launch = next(c for c in ptr["children"] if c["name"].startswith("launch:"))
    jlaunch = next(c for c in jtr["children"] if c["name"].startswith("launch:"))
    assert launch["attrs"]["costSource"] == "analytic"
    assert launch["attrs"]["kernelBytes"] == jlaunch["attrs"]["kernelBytes"]
    wait = next(c for c in ptr["children"] if c["name"] == "device_wait")
    assert wait["attrs"]["launches"] == 3


def test_trace_off_by_default(safety):
    _je, pe = safety
    assert pe.query("SELECT COUNT(*) FROM t").stats.trace is None


def test_trace_class_off_costs_nothing():
    t = PortTrace(False)
    with t.span("x") as sp:
        assert sp is None
    t.annotate(a=1)
    t.graft({"name": "y"})
    assert t.finish() is None
    on = PortTrace(True, query_id="q1")
    with on.span("a", k=1) as sp:
        on.annotate(b=2)
        on.graft({"name": "server", "ms": 1.0})
    d = on.finish()
    assert d["attrs"] == {"queryId": "q1"}
    assert d["children"][0]["attrs"] == {"k": 1, "b": 2}
    assert d["children"][0]["children"] == [{"name": "server", "ms": 1.0}]


def test_expired_deadline_raises(safety):
    je, pe = safety
    sql = "SET timeoutMs = 0.000001; SELECT city, COUNT(*) FROM t GROUP BY city"
    with pytest.raises(jax_safety.QueryTimeoutError, match="timeoutMs") as jerr:
        je.query(sql)
    with pytest.raises(port_safety.QueryTimeoutError, match="timeoutMs") as perr:
        pe.query(sql)
    assert str(perr.value) == str(jerr.value)
    assert pe.accountant.in_use == 0


def test_generous_deadline_passes(safety):
    _je, pe = safety
    assert pe.query("SET timeoutMs = 60000; SELECT COUNT(*) FROM t").rows[0][0] == 15000


def test_deadline_helper():
    import time

    port_safety.Deadline(None).check()
    d = port_safety.Deadline(0.0000001)
    time.sleep(0.001)
    with pytest.raises(port_safety.QueryTimeoutError):
        d.check()
    assert port_safety.Deadline(0.0).expired()
    assert port_safety.Deadline(None).bounded(50.0).timeout_ms == 50.0
    assert port_safety.Deadline(None).bounded(None).expires_at is None
    assert port_safety.Deadline(10_000.0).bounded(20.0).remaining_ms() <= 20.0


@pytest.mark.parametrize("sql", EXPLAIN_QUERIES + [
    "SELECT v, COUNT(*) FROM t GROUP BY v",
    "SELECT * FROM t LIMIT 3",
])
def test_estimate_segment_bytes_matches_jax(safety, sql):
    from pinot_tpu.query.planner import _needed_columns as jax_needed

    je, pe = safety
    jctx, pctx = jax_parse(sql), port_parse(sql)
    for jseg, pseg in zip(je.tables["t"].segments, pe.tables["t"].segments):
        jb = jax_safety.estimate_segment_bytes(jctx, jseg, jax_needed(jctx, jseg))
        pb = port_safety.estimate_segment_bytes(pctx, pseg, port_planner._needed_columns(pctx, pseg))
        assert pb == jb
        assert port_safety.estimate_segment_bytes(pctx, pseg) == jax_safety.estimate_segment_bytes(jctx, jseg)


def test_oversized_query_rejected_upfront(monkeypatch):
    je, pe = _safety_pair(budget=1000)
    from pinot_tpu_torch.query import executor

    def no_launch(*a, **k):
        raise AssertionError("a refused query launched")

    monkeypatch.setattr(executor, "launch_segment", no_launch)
    with pytest.raises(jax_safety.AdmissionError, match="device memory") as jerr:
        je.query("SELECT SUM(v) FROM t")
    with pytest.raises(port_safety.AdmissionError, match="device memory") as perr:
        pe.query("SELECT SUM(v) FROM t")
    assert str(perr.value) == str(jerr.value)
    assert pe.accountant.in_use == 0


def test_budget_released_after_queries(safety):
    _je, pe = safety
    for _ in range(3):
        pe.query("SELECT COUNT(*) FROM t")
    assert pe.accountant.in_use == 0


def test_release_on_failure(safety):
    _je, pe = safety
    with pytest.raises(Exception):
        pe.query("SELECT nonexistent_column FROM t")
    with pytest.raises(Exception):
        pe.query("SELECT SUM(city) FROM t")
    assert pe.accountant.in_use == 0


def test_metrics_accumulate(safety):
    _je, pe = safety
    pe.query("SELECT COUNT(*) FROM t")
    pe.query("SELECT city, SUM(v) FROM t GROUP BY city")
    snap = PORT_METRICS.snapshot()
    assert snap["counters"]["queries"] == 2
    assert snap["counters"]["docsScanned"] == 30000
    assert snap["histograms"]["queryLatency"]["count"] == 2
    assert snap["histograms"]["queryLatency"]["maxMs"] > 0
    with pytest.raises(port_safety.QueryTimeoutError):
        pe.query("SET timeoutMs = 0; SELECT COUNT(*) FROM t")
    assert PORT_METRICS.snapshot()["counters"]["queryExceptions"] == 1


def test_env_option_applies_and_query_overrides(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_OPT_numGroupsLimit", "7")
    monkeypatch.setenv("PINOT_TPU_OPT_enableNullHandling", "false")
    assert port_env.env_options() == jax_env.env_options()
    opts = port_env.env_options()
    assert opts["numGroupsLimit"] == 7 and opts["enableNullHandling"] is False
    je, pe = _safety_pair(n=500, segments=1)
    sql = "SELECT v, COUNT(*) FROM t GROUP BY v LIMIT 1000"
    res = pe.query(sql)
    assert len(res.rows) <= 7
    assert_same_rows(res.rows, je.query(sql).rows)
    res2 = pe.query("SET numGroupsLimit = 1000; " + sql)
    assert len(res2.rows) > 7
    layered = {"numGroupsLimit": 3}
    port_env.apply_env_defaults(layered, {"PINOT_TPU_OPT_numGroupsLimit": "9", "PINOT_TPU_OPT_x": "abc"})
    assert layered == {"numGroupsLimit": 3, "x": "abc"}


def test_workload_scheduler():
    from pinot_tpu_torch.query.ir import QueryContext

    ws = port_safety.WorkloadScheduler(secondary_slots=1)
    ctx = QueryContext(table="t", select_list=[])
    for r in [ws.acquire(ctx) for _ in range(10)]:  # primary: never queued
        r()
    ws = port_safety.WorkloadScheduler(secondary_slots=2)
    ctx = QueryContext(table="t", select_list=[], options={"isSecondaryWorkload": "true"})
    r1 = ws.acquire(ctx, port_safety.Deadline(50.0))
    r2 = ws.acquire(ctx, port_safety.Deadline(50.0))
    with pytest.raises(port_safety.AdmissionError):
        ws.acquire(ctx, port_safety.Deadline(50.0))
    r1()
    r3 = ws.acquire(ctx, port_safety.Deadline(50.0))
    r3()
    r2()


def test_secondary_workload_option_and_slots():
    je, pe = _safety_pair(n=100, segments=1, secondary_slots=1)
    assert pe.scheduler.secondary_slots == 1
    sql = "SET isSecondaryWorkload = true; SELECT COUNT(*) FROM t"
    assert pe.query(sql).rows == je.query(sql).rows == [(100,)]
    hold = pe.scheduler.acquire(port_parse(sql))  # the one slot taken
    with pytest.raises(port_safety.AdmissionError, match="secondary workload queue full"):
        pe.query("SET timeoutMs = 20; " + sql)
    hold()
    assert pe.accountant.in_use == 0


def test_memory_accountant():
    acc = port_safety.MemoryAccountant(100)
    a = acc.acquire(60)
    with pytest.raises(port_safety.AdmissionError):
        acc.acquire(50)
    b = acc.acquire(40)
    acc.release(a)
    acc.release(b)
    acc.release(b)  # idempotent
    assert acc.in_use == 0


# ---------------------------------------------------------------------------
# the slow-query log
# ---------------------------------------------------------------------------
SLOWLOG_STABLE_KEYS = ("queryId", "sql", "planFingerprint", "shapeFingerprint", "resultCache", "rows",
                       "numDocsScanned", "numSegmentsProcessed", "partialResult", "numExceptions",
                       "kernelBytes", "costSource", "error")


def test_slow_log_matches_jax(safety):
    je, pe = _safety_pair()
    je.slow_queries = JaxSlowLog(capacity=8, slow_ms=1e9)
    pe.slow_queries = PortSlowLog(capacity=8, slow_ms=1e9)
    sqls = ["SELECT COUNT(*) FROM t", "SELECT city, SUM(v) FROM t GROUP BY city"]
    for eng, mod in ((je, jax_safety), (pe, port_safety)):
        for sql in sqls:
            eng.query(sql)
        eng.query("EXPLAIN PLAN FOR SELECT COUNT(*) FROM t")  # not served: not logged
        with pytest.raises(mod.QueryTimeoutError):
            eng.query("SET timeoutMs = 0; SELECT COUNT(*) FROM t")
    jsnap, psnap = je.slow_queries.snapshot(), pe.slow_queries.snapshot()
    assert len(psnap) == len(jsnap) == 3
    for j, p in zip(jsnap, psnap):
        assert set(p) <= set(j) | {"kernelFlops", "rooflinePct", "rowsPerSec", "compileMs"}
        for k in SLOWLOG_STABLE_KEYS:
            assert p.get(k) == j.get(k), k
    assert psnap[0]["error"].startswith("QueryTimeoutError")
    assert psnap[1]["costSource"] == "analytic" and psnap[1]["rows"] == 2
    assert PORT_METRICS.snapshot()["counters"]["broker.slowQueries"] == 1  # the failure only


def test_slow_log_keeps_slow_traces_and_ring_capacity():
    _je, pe = _safety_pair(n=200, segments=1)
    pe.slow_queries = PortSlowLog(capacity=2, slow_ms=0.0)
    for _ in range(3):
        pe.query("SET trace = true; SELECT COUNT(*) FROM t")
    snap = pe.slow_queries.snapshot()
    assert len(pe.slow_queries) == 2 and len(snap) == 2
    assert all(e["trace"]["name"] == "query" for e in snap)
    assert pe.slow_queries.snapshot(limit=1) == snap[:1]


# ---------------------------------------------------------------------------
# DDL and cursors
# ---------------------------------------------------------------------------
DDL_STATEMENTS = [
    "CREATE TABLE events (id LONG DIMENSION, city STRING, tags STRING MV, v DOUBLE METRIC NULLABLE, "
    "ts TIMESTAMP, day INT TIME, PRIMARY KEY (id)) WITH (invertedIndexColumns = 'city,tags', "
    "rangeIndexColumns = 'v', timeColumnName = 'ts', retentionDays = '30', upsertMode = 'full', "
    "comparisonColumn = 'ts', streamType = 'kafka', topic = 'ev', partitionColumn = 'id', numPartitions = '4')",
    "CREATE TABLE m (k INT, j JSON, txt STRING) WITH (jsonIndexColumns = 'j', textIndexColumns = 'txt', "
    "noDictionaryColumns = 'k', sortedColumn = 'k', bloomFilterColumns = 'txt', dedup = 'true');",
    "CREATE TABLE plain (a INT, b STRING)",
]


@pytest.mark.parametrize("stmt", DDL_STATEMENTS)
def test_ddl_show_create_table_matches_jax(stmt):
    js, ps = jax_ddl.parse_ddl(stmt), port_ddl.parse_ddl(stmt)
    assert ps.kind == js.kind == "create_table" and ps.table == js.table
    assert ps.schema.to_dict() == js.schema.to_dict()
    text = port_ddl.show_create_table(ps.schema, ps.config)
    assert text == jax_ddl.show_create_table(js.schema, js.config)
    # the round-trip fixed point
    again = port_ddl.parse_ddl(text)
    assert port_ddl.show_create_table(again.schema, again.config) == text


def test_ddl_through_engine_sql():
    je, pe = JaxEngine(), PortEngine(device="cpu")
    script = [DDL_STATEMENTS[2], "SHOW TABLES", "SHOW CREATE TABLE plain", "SELECT COUNT(*) FROM plain",
              "DROP TABLE plain", "SHOW TABLES"]
    for stmt in script:
        assert pe.sql(stmt).rows == je.sql(stmt).rows, stmt
    assert not port_ddl.is_ddl("SELECT 1 FROM t") and port_ddl.is_ddl("  show tables")
    with pytest.raises(KeyError):
        pe.sql("DROP TABLE plain")
    with pytest.raises(Exception, match="expected CREATE / DROP / SHOW"):
        port_ddl.parse_ddl("ALTER TABLE x")


def _paged(store_mod, table_cls, rows, page_size=3):
    store = store_mod.ResponseStore(ttl_seconds=300.0, max_entries=4)
    cid = store.register(table_cls(columns=["a", "b"], rows=rows), page_size=page_size)
    pages = [store.fetch(cid, p) for p in range(3)]
    for p in pages:
        p.pop("cursorId")
    return store, cid, pages


def test_response_store_matches_jax(monkeypatch):
    rows = [(i, f"r{i}") for i in range(8)]
    _, _, jpages = _paged(jax_cursors, JaxResultTable, rows)
    store, cid, ppages = _paged(port_cursors, PortResultTable, rows)
    assert ppages == jpages
    assert ppages[2]["rows"] == [[6, "r6"], [7, "r7"]] and ppages[0]["numPages"] == 3
    assert store.delete(cid) and not store.delete(cid)
    with pytest.raises(KeyError, match="not found"):
        store.fetch(cid, 0)
    # capacity: the oldest entry goes first
    ids = [store.register(PortResultTable(columns=["a"], rows=[(i,)])) for i in range(5)]
    with pytest.raises(KeyError):
        store.fetch(ids[0], 0)
    assert store.fetch(ids[-1], 0)["rows"] == [[4]]
    # TTL applies on read
    now = [1000.0]
    monkeypatch.setattr(port_cursors.time, "monotonic", lambda: now[0])
    ttl = port_cursors.ResponseStore(ttl_seconds=10.0)
    c = ttl.register(PortResultTable(columns=["a"], rows=[(1,)]))
    now[0] += 11.0
    with pytest.raises(KeyError):
        ttl.fetch(c, 0)


# ---------------------------------------------------------------------------
# the distributed engine: trace spans, and the three refusals beside what
# the JAX engine does with each
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dist_breadth():
    rng = np.random.default_rng(53)
    n = 2000
    data = {
        "city": rng.choice(["sf", "nyc", "la"], n).astype(object),
        "dept": rng.choice(["eng", "ops", "biz", "hr"], n).astype(object),
        "v": rng.integers(0, 10_000, n),
        "score": np.round(rng.random(n) * 100, 3),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
        jax_ops.scan_backend.cache_clear()
        return _dist_pair(_breadth_schema, data)


def test_dist_trace_spans_match_jax(dist_breadth):
    jd, pd = dist_breadth
    sql = "SET trace = true; SELECT city, SUM(v) FROM t WHERE v > 100 GROUP BY city"
    jres, pres = jd.query(sql), pd.query(sql)
    assert_same_rows(pres.rows, jres.rows)
    names = [c["name"] for c in pres.stats.trace["children"]]
    assert names == ["plan", "run", "reduce"] == [c["name"] for c in jres.stats.trace["children"]]
    plan = pres.stats.trace["children"][0]["attrs"]
    assert set(plan) == {"shapeFp", "planCache"} and len(plan["shapeFp"]) == 12
    assert pd.query(sql).stats.trace["children"][0]["attrs"]["planCache"] == "hit"
    assert pd.query("SELECT COUNT(*) FROM t").stats.trace is None


def test_dist_set_ops_refused_where_jax_ignores_them(dist_breadth):
    jd, pd = dist_breadth
    first = "SELECT city, COUNT(*) FROM t WHERE v > 5000 GROUP BY city"
    sql = first + " UNION SELECT city, COUNT(*) FROM t WHERE v <= 5000 GROUP BY city"
    # the JAX engine answers the first component only (a reference fault)
    assert_same_rows(jd.query(sql).rows, jd.query(first).rows)
    with pytest.raises(NotImplementedError, match="set operations.*Queue 3"):
        pd.query(sql)


def test_dist_explain_refused_where_jax_runs_the_query(dist_breadth):
    jd, pd = dist_breadth
    q = "SELECT city, COUNT(*) FROM t GROUP BY city"
    for prefix in ("EXPLAIN PLAN FOR ", "EXPLAIN ANALYZE "):
        # the JAX engine ignores EXPLAIN and returns the query's rows
        assert_same_rows(jd.query(prefix + q).rows, jd.query(q).rows)
        with pytest.raises(NotImplementedError, match="EXPLAIN.*Queue 3"):
            pd.query(prefix + q)


def test_dist_subquery_refused_where_jax_faults(dist_breadth):
    jd, pd = dist_breadth
    sql = "SELECT COUNT(*) FROM t WHERE dept IN (SELECT dept FROM t WHERE score > 99.8)"
    with pytest.raises(TypeError):
        jd.query(sql)
    with pytest.raises(NotImplementedError, match=r"IN \(SELECT.*Queue 3"):
        pd.query(sql)
    # a JOIN goes to the multi-stage engine, as the JAX engine routes it (a
    # self-join through an alias facade, many-to-many on v)
    join = "SELECT t.city, COUNT(*), SUM(t.v) FROM t JOIN t u ON t.v = u.v GROUP BY t.city ORDER BY t.city"
    assert_same_rows(pd.query(join).rows, jd.query(join).rows, ordered=True)
    assert pd._mse_engine is not None and pd._mse_engine.plan_misses == 1
