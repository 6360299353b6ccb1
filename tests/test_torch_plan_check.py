"""The port's plan-time static check (analysis/plan_check.py) against the
JAX package's.

A corpus of queries (the malformed classes of tests/test_plan_check.py and
more: unknown columns and functions, wrong arities, aggregates and windows
where they cannot be, literal keys, bad LIMIT / OFFSET, type hazards, and
queries that must pass) is parsed by each package's parser and checked
against each package's schema: the issues (code, message, where) and the
raised PlanCheckError's text must be identical.  Each of the port's three
engines (segment, distributed, multi-stage) must raise the PlanCheckError
before anything reaches the fused scan (zero calls of its wrapper, with the
plans made for the kernel backend).
"""
import numpy as np
import pytest

import pinot_tpu  # noqa: F401
from pinot_tpu.analysis import plan_check as jax_pc
from pinot_tpu.query.ir import AggregationSpec as JaxAgg, Expr as JaxExpr, QueryContext as JaxCtx
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.sql.parser import parse_query as jax_parse

from pinot_tpu_torch.analysis import plan_check as port_pc
from pinot_tpu_torch.parallel.engine import DistributedEngine
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query.ir import AggregationSpec as PortAgg, Expr as PortExpr, QueryContext as PortCtx
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import parse_query as port_parse

from test_torch_cache import _dim_table
from test_torch_dist_engine import _stacked_pair
from test_torch_query import build_engines, make_data, spy_kernel_calls
from torch_port_state import port_state  # noqa: F401


def _schema(S):
    return S.Schema(
        "demo",
        [
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("amount", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
            S.FieldSpec("n", S.DataType.INT, role=S.FieldRole.METRIC),
            S.FieldSpec("big", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
        ],
    )


GOOD = [
    "SELECT COUNT(*) FROM demo",
    "SELECT city, SUM(amount) FROM demo GROUP BY city ORDER BY SUM(amount) DESC",
    "SELECT MAX(amount) - MIN(amount) FROM demo",
    "SELECT DATETRUNC('day', ts), COUNT(*) FROM demo GROUP BY DATETRUNC('day', ts)",
    "SELECT city, SUM(n) FROM demo GROUP BY city HAVING SUM(n) > 10",
    "SELECT DISTINCTCOUNTHLL(city) FROM demo",
    "SELECT city AS c, COUNT(*) FROM demo GROUP BY city ORDER BY c",
    "SELECT PERCENTILE(amount, 95) FROM demo",
    "SELECT SUM(amount) FROM demo WHERE n BETWEEN 5 AND 50",
    "SELECT city, n, ROW_NUMBER() OVER (PARTITION BY city ORDER BY n) FROM demo",
    "SELECT UPPER(city), COUNT(*) FROM demo GROUP BY UPPER(city)",
    "SELECT n + 1, big * 2 FROM demo WHERE amount > 1.5 LIMIT 5",
    "SELECT city, COUNT(*) FILTER (WHERE n > 5) FROM demo GROUP BY city",
    "SELECT CASE WHEN n > 5 THEN 'hi' ELSE 'lo' END, COUNT(*) FROM demo "
    "GROUP BY CASE WHEN n > 5 THEN 'hi' ELSE 'lo' END",
]

BAD = [
    "SELECT FROBNICATE(amount) FROM demo",
    "SELECT SUM(MAX(amount)) FROM demo",
    "SELECT city FROM demo WHERE SUM(amount) > 10",
    "SELECT POWER(n) FROM demo",
    "SELECT COUNT(*) FROM demo WHERE n = 'abc'",
    "SELECT COUNT(*) FROM demo WHERE REGEXP_LIKE(n, 'a.*')",
    "SELECT COUNT(*) FROM demo WHERE n = 99999999999",
    "SELECT nosuchcol FROM demo",
    "SELECT COUNT(*) FROM demo WHERE n = 1.5",
    "SELECT city, COUNT(*) FROM demo GROUP BY city ORDER BY amount",
    "SELECT SUM(nosuchcol) FROM demo",
    "SELECT city, COUNT(*) FROM demo WHERE missing > 3 GROUP BY city",
    "SELECT city, COUNT(*) FROM demo GROUP BY nosuch",
    "SELECT ABS(n, n) FROM demo",
    "SELECT FROBNICATE(city), SUM(MAX(n)) FROM demo",
    "SELECT city, COUNT(*) FROM demo GROUP BY city HAVING SUM(MIN(n)) > 3",
    "SELECT city, SUM(n) FROM demo GROUP BY SUM(n)",
    "SELECT COUNT(*) FROM demo WHERE city LIKE 3 AND n = 'x'",
    "SELECT NOSUCHAGG(n) FROM demo",
    "SELECT city, MEDIANX(n) FROM demo GROUP BY city",
    "SELECT COUNT(*) FROM demo WHERE TEXT_MATCH(n, 'a')",
    "SELECT city, FOO(n) OVER (PARTITION BY city) FROM demo",
    "SELECT city, SUM(SUM(n)) OVER (PARTITION BY city) FROM demo",
    "SELECT COUNT(*) FROM demo WHERE n IN (1, 2.5)",
    "SELECT COUNT(*) FROM demo WHERE n = -3000000000",
    "SELECT SUM(n) FROM demo LIMIT 5 OFFSET 2",
    "SELECT COUNT(*) FROM demo WHERE year = 'abc'",
    "SELECT city, SUM(amount) FROM demo GROUP BY city ORDER BY n",
]


def _issues(pc, parse, S, sql):
    try:
        ctx = parse(sql)
    except Exception as exc:  # noqa: BLE001 — the parsers must agree on refusals too
        return ("parse", type(exc).__name__, str(exc))
    return [(i.code, i.message, i.where) for i in pc.collect_issues(ctx, _schema(S))]


@pytest.mark.parametrize("sql", GOOD + BAD)
def test_same_issues_as_jax(sql):
    want = _issues(jax_pc, jax_parse, jax_schema, sql)
    got = _issues(port_pc, port_parse, port_schema, sql)
    assert got == want
    if sql in GOOD:
        assert want == []
    if isinstance(want, list) and want:
        with pytest.raises(jax_pc.PlanCheckError) as je:
            jax_pc.check_plan(jax_parse(sql), _schema(jax_schema))
        with pytest.raises(port_pc.PlanCheckError) as pe:
            port_pc.check_plan(port_parse(sql), _schema(port_schema))
        assert str(pe.value) == str(je.value)
        assert pe.value.to_dict() == je.value.to_dict()
        assert isinstance(pe.value, ValueError)


@pytest.mark.parametrize("case", ["literal_key", "limit", "offset", "several"])
def test_direct_ir_cases(case):
    def build(Ctx, Agg, Expr):
        if case == "literal_key":
            return Ctx(table="demo", select_list=[Agg(function="count", expr=None)], group_by=[Expr.lit(7)])
        if case == "limit":
            return Ctx(table="demo", select_list=[Expr.col("city")], limit=-1)
        if case == "offset":
            return Ctx(table="demo", select_list=[Expr.col("city")], offset=-5)
        return Ctx(table="demo", select_list=[Expr.call("frobnicate", Expr.col("city"))],
                   group_by=[Expr.lit(1)], limit=-2)

    want = [(i.code, i.message, i.where) for i in jax_pc.collect_issues(build(JaxCtx, JaxAgg, JaxExpr))]
    got = [(i.code, i.message, i.where) for i in port_pc.collect_issues(build(PortCtx, PortAgg, PortExpr))]
    assert got == want and want


def test_check_plan_cached_remembers_clean_fingerprints():
    port_pc._CHECKED_FPS.clear()
    ctx = port_parse("SELECT COUNT(*) FROM demo")
    port_pc.check_plan_cached(ctx)
    assert ctx.fingerprint() in port_pc._CHECKED_FPS
    bad = port_parse("SELECT FROBNICATE(amount) FROM demo")
    with pytest.raises(port_pc.PlanCheckError):
        port_pc.check_plan_cached(bad)
    assert bad.fingerprint() not in port_pc._CHECKED_FPS


ENGINE_BAD = [
    ("SELECT FROBNICATE(v) FROM t", "UNKNOWN_FUNCTION"),
    ("SELECT SUM(MAX(v)) FROM t", "NESTED_AGGREGATION"),
    ("SELECT POWER(v) FROM t", "BAD_ARITY"),
]


@pytest.mark.parametrize("sql,code", ENGINE_BAD, ids=[c for _, c in ENGINE_BAD])
def test_segment_engine_raises_before_any_launch(monkeypatch, sql, code):
    _j, port = build_engines({"t": (True, [make_data(5, 400)])})
    calls = spy_kernel_calls(monkeypatch, port_planner)
    with pytest.raises(port_pc.PlanCheckError) as ei:
        port.sql(sql)
    assert ei.value.code == code and calls == []
    port.sql("SELECT city, COUNT(*) FROM t GROUP BY city LIMIT 10")
    assert len(calls) == 1


DIST_BAD = [
    ("SELECT FROBNICATE(rev) FROM t", "UNKNOWN_FUNCTION"),
    ("SELECT SUM(MAX(rev)) FROM t", "NESTED_AGGREGATION"),
    ("SELECT POWER(rev) FROM t", "BAD_ARITY"),
]


@pytest.mark.parametrize("sql,code", DIST_BAD, ids=[c for _, c in DIST_BAD])
def test_distributed_and_join_engines_raise_before_any_launch(monkeypatch, sql, code):
    _js, ps = _stacked_pair()
    dist = DistributedEngine(device="cpu")
    dist.register_table("t", ps)
    dist.register_table("dim", _dim_table())
    calls = spy_kernel_calls(monkeypatch, port_planner)
    with pytest.raises(port_pc.PlanCheckError) as ei:
        dist.query(sql)
    assert ei.value.code == code
    join_sql = sql.replace("FROM t", "FROM t JOIN dim ON t.yr = dim.dyr")
    with pytest.raises(port_pc.PlanCheckError) as ej:
        dist.query(join_sql)
    assert ej.value.code == code
    assert calls == [] and dist.plan_misses == 0
    dist.query("SELECT city, COUNT(*) FROM t GROUP BY city LIMIT 10")
    dist.query("SELECT dim.label, COUNT(*) FROM t JOIN dim ON t.yr = dim.dyr GROUP BY dim.label")
    assert len(calls) == 2
