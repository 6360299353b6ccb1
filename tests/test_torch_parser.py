"""The port's SQL parser yields the JAX parser's QueryContext.

For every query of the slice's SQL set, the two parsers must agree on the
full fingerprint (every literal included), on the shape fingerprint against
each package's own segment metadata, and on the extracted literal
parameters of every predicate.  JOIN clauses (INNER / LEFT, equi-keys),
window functions, CASE, FILTER (WHERE ...), EXPLAIN, set operations, IN
(SELECT ...) and GAPFILL parse as in the JAX package; RIGHT / FULL / CROSS
JOIN raise SqlParseError in both."""
import pytest

import pinot_tpu  # noqa: F401
from pinot_tpu.query.shape import column_info_from as jax_column_info
from pinot_tpu.sql.parser import parse_query as jax_parse

from pinot_tpu_torch.query.shape import column_info_from as port_column_info
from pinot_tpu_torch.sql.parser import parse_query as port_parse

from test_torch_query import CONFIG2, INDEX_QUERIES, SQL_SET, engines  # noqa: F401  (fixture)

EXTRA = [
    "SELECT DISTINCTCOUNTHLL(city), PERCENTILE(v, 90) FROM t",  # parses; fails at plan time in the port
    "SELECT t.city, SUM(t.v) AS s FROM t GROUP BY t.city ORDER BY s DESC LIMIT 2 OFFSET 1",
    "SELECT DISTINCT city, year FROM t",
    "SELECT COUNT(*) FROM t WHERE v > -5 AND v <= 10.5 OPTION(timeoutMs=100)",
    "SELECT SUM(v) / COUNT(*) FROM t WHERE city <> 'sf'",
    # window functions, CASE, FILTER (WHERE ...), expressions, selections
    "SELECT ROW_NUMBER() OVER (ORDER BY v) FROM t",
    "SELECT CASE WHEN v > 1 THEN 1 ELSE 0 END FROM t",
    "SELECT SUM(v) FILTER (WHERE city = 'sf'), COUNT(*) FILTER (WHERE year > 2010 AND tag IS NULL) FROM t",
    "SELECT city, SUM(v) OVER (PARTITION BY city ORDER BY year ROWS BETWEEN 2 PRECEDING AND CURRENT ROW), "
    "LAG(v, 2, 0) OVER (ORDER BY day), NTILE(3) OVER (ORDER BY v DESC) FROM t",
    "SELECT AVG(v) OVER (ORDER BY day RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) FROM t WHERE year > 2001",
    "SELECT MOD(year, 5), UPPER(city), SUM(v * 2.5) FROM t GROUP BY MOD(year, 5), UPPER(city)",
    "SELECT city, v * 2 FROM t WHERE DATETRUNC('day', v) > 3 ORDER BY v * 2 DESC NULLS FIRST LIMIT 5 OFFSET 2",
    "SELECT * FROM t WHERE UPPER(city) = 'SF' AND v % 3 = 1 LIMIT 3",
    "SELECT CASE WHEN city IN ('sf', 'la') THEN price WHEN NOT (v BETWEEN 1 AND 5) THEN v END FROM t",
    # the front door (these four raised NotImplementedError before the port had them)
    "EXPLAIN PLAN FOR SELECT COUNT(*) FROM t",
    "SELECT COUNT(*) FROM t UNION SELECT COUNT(*) FROM t",
    "SELECT COUNT(*) FROM t WHERE city IN (SELECT city FROM u)",
    "SELECT GAPFILL(year, 2000, 2010, 1), COUNT(*) FROM t GROUP BY year",
]
SQLS = [q[0] for q in SQL_SET] + [q.format(t="t") for q, _ in INDEX_QUERIES] + [CONFIG2] + EXTRA


def _values(p):
    """A predicate's values; an IN (SELECT ...) marker as its query's full
    fingerprint (the two packages' Subquery classes differ)."""
    if p.values is None:
        return None
    return tuple(("subquery", v.ctx.fingerprint()) if type(v).__name__ == "Subquery" else v
                 for v in p.values)


def _literals(ctx):
    out = []
    for node in (ctx.filter, ctx.having):
        if node is not None:
            out.extend((p.ptype.value, _values(p), p.lower, p.upper, p.lower_inclusive, p.upper_inclusive)
                       for p in node.predicates())
    return out, ctx.limit, ctx.offset, sorted(ctx.options.items())


@pytest.mark.parametrize("sql", SQLS)
def test_parser_matches_jax(engines, sql):  # noqa: F811
    jax_engine, port_engine, _ = engines
    jctx, pctx = jax_parse(sql), port_parse(sql)
    assert pctx.fingerprint() == jctx.fingerprint()
    jseg = jax_engine.tables["t"].segments[0]
    pseg = port_engine.tables["t"].segments[0]
    assert pctx.shape_fingerprint(port_column_info(pseg)) == jctx.shape_fingerprint(jax_column_info(jseg))
    assert _literals(pctx) == _literals(jctx)
    assert pctx.column_names_out() == jctx.column_names_out()


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT COUNT(*) FROM t JOIN u ON t.a = u.a",
        "SELECT COUNT(*) FROM t LEFT JOIN u ON t.a = u.a",
    ],
)
def test_later_slice_syntax_raises(sql):
    """JOIN clauses (the multi-stage slice) parse into the JAX package's
    JoinClause: the same table, alias, type and keys, the same fingerprint,
    and qualifiers left for the multi-stage planner."""
    jctx, pctx = jax_parse(sql), port_parse(sql)
    assert [(j.table, j.alias, j.join_type, j.left_key.op, j.right_key.op) for j in pctx.joins] == [
        (j.table, j.alias, j.join_type, j.left_key.op, j.right_key.op) for j in jctx.joins]
    assert [j.fingerprint() for j in pctx.joins] == [j.fingerprint() for j in jctx.joins]
    assert pctx.fingerprint() == jctx.fingerprint()
    assert pctx.shape_fingerprint() == jctx.shape_fingerprint()
    assert pctx.joins[0].left_key.op == "t.a"


@pytest.mark.parametrize("kind", ["RIGHT", "FULL", "CROSS"])
def test_unsupported_join_kinds_raise_in_both(kind):
    from pinot_tpu.sql.parser import SqlParseError as JaxSqlParseError
    from pinot_tpu_torch.sql.parser import SqlParseError as PortSqlParseError

    sql = f"SELECT COUNT(*) FROM t {kind} JOIN u ON t.a = u.a"
    with pytest.raises(JaxSqlParseError, match=f"{kind} JOIN is not supported"):
        jax_parse(sql)
    with pytest.raises(PortSqlParseError, match=f"{kind} JOIN is not supported"):
        port_parse(sql)
