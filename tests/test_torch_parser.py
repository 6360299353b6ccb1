"""The port's SQL parser yields the JAX parser's QueryContext.

For every query of the slice's SQL set, the two parsers must agree on the
full fingerprint (every literal included), on the shape fingerprint against
each package's own segment metadata, and on the extracted literal
parameters of every predicate.  Constructs of later slices raise
NotImplementedError in the port."""
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
]
SQLS = [q[0] for q in SQL_SET] + [q.format(t="t") for q, _ in INDEX_QUERIES] + [CONFIG2] + EXTRA


def _literals(ctx):
    out = []
    for node in (ctx.filter, ctx.having):
        if node is not None:
            out.extend((p.ptype.value, p.values, p.lower, p.upper, p.lower_inclusive, p.upper_inclusive)
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
        "EXPLAIN PLAN FOR SELECT COUNT(*) FROM t",
        "SELECT COUNT(*) FROM t UNION SELECT COUNT(*) FROM t",
        "SELECT COUNT(*) FROM t JOIN u ON t.a = u.a",
        "SELECT COUNT(*) FROM t WHERE city IN (SELECT city FROM u)",
        "SELECT ROW_NUMBER() OVER (ORDER BY v) FROM t",
        "SELECT CASE WHEN v > 1 THEN 1 ELSE 0 END FROM t",
    ],
)
def test_later_slice_syntax_raises(sql):
    jax_parse(sql)  # the reference parses it
    with pytest.raises(NotImplementedError):
        port_parse(sql)
