"""The port's extended aggregations (PERCENTILEKLL, DISTINCTCOUNTTHETA with
sub-filter set expressions, MODE, FREQUENTLONGS, DISTINCTSUM/AVG,
FIRST/LAST_WITH_TIME) against the JAX package.

Partials of each function on the same numpy inputs (ties in the time
column included), the KMV merge, and SQL through both packages' engines:
QueryEngine on one segment and on three with differing dictionaries,
DistributedEngine dense and sparse at one launch and at four (the JAX
DistributedEngine refuses the pairwise-merge functions outside its sparse
path, so those queries are held against the JAX QueryEngine over the same
data in one segment).

Tolerances: integer results and every partial field identical (histograms,
KMV rows, (t, v) pairs); float results to rtol 1e-9.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from pinot_tpu.query import functions as jf
from pinot_tpu.query import aggs_extra as jx
from pinot_tpu.query import sketches as jsk

from pinot_tpu_torch.query import aggs_extra as px
from pinot_tpu_torch.query import functions as pf
from pinot_tpu_torch.query import sketches as psk

from test_torch_sketches import (
    as_jax,
    as_port,
    assert_same_partial,
    assert_same_rows,
    dist_engines,
    dist_reference_rows,
    sse_engines,
)


@pytest.fixture(scope="module")
def sse():
    return sse_engines()


@pytest.fixture(scope="module")
def dist():
    return dist_engines()


def _pair(name, literal_args=(), binding=None):
    j = jf.get_agg_function(name).with_args(literal_args)
    p = pf.get_agg_function(name).with_args(literal_args)
    if binding is not None:
        j = j.bind_column(jsk.ColumnBinding(**binding))
        p = p.bind_column(psk.ColumnBinding(**binding))
    return j, p


def _inputs(case, n=5000, seed=4):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.85
    keys = rng.integers(0, 7, n).astype(np.int32)
    if case in ("kll", "theta"):
        vals = np.concatenate([rng.standard_normal(n // 2) * 1e4, rng.integers(-10, 10, n - n // 2)])
        vals[:3] = [0.0, 1e-12, -3e13]
    elif case in ("mode", "frequentlongs", "distinctsum", "distinctavg"):
        vals = rng.integers(0, 40, n).astype(np.int32)  # value offsets
    else:  # (value, time) with many tied times
        vals = (rng.integers(-1000, 1000, n).astype(np.int64), rng.integers(0, 25, n).astype(np.int64))
    return vals, mask, keys


PARTIAL_CASES = {
    "kll": ("percentilekll", (90,), None),
    "kll/k400": ("percentilekll", (5, 400), None),
    "theta": ("distinctcounttheta", (), None),
    "mode": ("mode", (), dict(kind="rawint", domain=40, base=3, min_value=3, max_value=42)),
    "frequentlongs": ("frequentlongs", (3,), dict(kind="rawint", domain=40, base=3, min_value=3, max_value=42)),
    "distinctsum": ("distinctsum", (), dict(kind="rawint", domain=40, base=3, min_value=3, max_value=42)),
    "distinctavg": ("distinctavg", (), dict(kind="rawint", domain=40, base=3, min_value=3, max_value=42)),
    "lastwithtime": ("lastwithtime", (), None),
    "firstwithtime": ("firstwithtime", (), None),
}


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
@pytest.mark.parametrize("grouped", [False, True])
def test_partials_match_jax(case, grouped):
    name, lits, binding = PARTIAL_CASES[case]
    jfn, pfn = _pair(name, lits, binding)
    vals, mask, keys = _inputs(case.split("/")[0])
    if grouped:
        jp = jfn.partial_grouped(as_jax(vals), jnp.asarray(mask), jnp.asarray(keys), 7)
        pp = pfn.partial_grouped(as_port(vals), torch.from_numpy(mask), torch.from_numpy(keys), 7)
    else:
        jp = jfn.partial(as_jax(vals), jnp.asarray(mask))
        pp = pfn.partial(as_port(vals), torch.from_numpy(mask))
    assert_same_partial(jp, pp)
    # finals on the host partials, and the merge of two halves
    np.testing.assert_array_equal(
        np.asarray(pfn.final({k: np.asarray(v) for k, v in pp.items()}), dtype=object),
        np.asarray(jfn.final({k: np.asarray(v) for k, v in jp.items()}), dtype=object),
    )


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_kmv_merge_matches_jax(kind):
    """The pairwise KMV merge, on host arrays (the reduce) and on tensors
    (the distributed engine's combine), equals the JAX package's."""
    jfn, pfn = _pair("distinctcounttheta")
    v1, m1, k1 = _inputs("theta", seed=1)
    v2, m2, k2 = _inputs("theta", seed=2)
    ja = jfn.partial_grouped(jnp.asarray(v1), jnp.asarray(m1), jnp.asarray(k1), 7)
    jb = jfn.partial_grouped(jnp.asarray(v2), jnp.asarray(m2), jnp.asarray(k2), 7)
    want = jfn.merge({k: np.asarray(v) for k, v in ja.items()}, {k: np.asarray(v) for k, v in jb.items()})
    pa = pfn.partial_grouped(torch.from_numpy(v1), torch.from_numpy(m1), torch.from_numpy(k1), 7)
    pb = pfn.partial_grouped(torch.from_numpy(v2), torch.from_numpy(m2), torch.from_numpy(k2), 7)
    if kind == "numpy":
        pa, pb = ({k: v.numpy() for k, v in p.items()} for p in (pa, pb))
    got = pfn.merge(pa, pb)
    assert isinstance(got["kmv"], torch.Tensor if kind == "torch" else np.ndarray)
    assert_same_partial(want, got)


@pytest.mark.parametrize("literal_args", [
    ("year > 2010",),
    ("year > 2010", "city = 'sf'", "SET_INTERSECT($1, $2)"),
    ("year > 2010", "city = 'sf'", "SET_UNION($1, SET_DIFF($2, $1))"),
])
def test_theta_subfilter_parse_matches_jax(literal_args):
    jfn, pfn = _pair("distinctcounttheta", literal_args)
    assert (pfn.filter_exprs, pfn.post_expr) == (jfn.filter_exprs, jfn.post_expr)
    assert [n.fingerprint() for n in pfn.filter_nodes] == [n.fingerprint() for n in jfn.filter_nodes]


SSE_SQL = [
    "SELECT PERCENTILEKLL(v, 99), PERCENTILEKLL(price, 10), PERCENTILEKLL(big, 50, 400) FROM t",
    "SELECT DISTINCTCOUNTTHETA(v), DISTINCTCOUNTTHETA(big), DISTINCTCOUNTRAWTHETA(price) FROM t WHERE year > 2003",
    "SELECT DISTINCTCOUNTTHETA(v, 'year > 2010', 'city = ''sf''', 'SET_INTERSECT($1, $2)'), "
    "DISTINCTCOUNTTHETA(big, 'day < 100') FROM t",
    "SELECT MODE(day), FREQUENTLONGS(year, 4), DISTINCTSUM(day), DISTINCTAVG(year) FROM t WHERE v > 100",
    "SELECT city, MODE(year), DISTINCTCOUNTTHETA(v), LASTWITHTIME(v, day, 'LONG'), "
    "FIRSTWITHTIME(big, year, 'LONG') FROM t GROUP BY city ORDER BY city LIMIT 20",
    "SELECT year, PERCENTILEKLL(v, 75), FREQUENTLONGS(day, 2), LASTWITHTIME(price, day, 'DOUBLE') FROM t "
    "GROUP BY year ORDER BY year LIMIT 50",
    "SET maxDenseGroups = 4; SELECT year, day, DISTINCTCOUNTTHETA(v), FIRSTWITHTIME(v, big, 'LONG'), MODE(day) "
    "FROM t GROUP BY year, day ORDER BY year, day LIMIT 40",
    "SELECT LASTWITHTIME(v, year, 'LONG'), FIRSTWITHTIME(v, year, 'LONG') FROM t",
]


@pytest.mark.parametrize("layout", ["one", "multi"])
@pytest.mark.parametrize("sql", SSE_SQL, ids=[s[:60] for s in SSE_SQL])
def test_segment_engine_matches_jax(sse, layout, sql):
    je, pe = sse[layout]
    assert_same_rows(pe.query(sql).rows, je.query(sql).rows, ordered="ORDER BY" in sql)


DIST_SQL = [
    "SELECT DISTINCTCOUNT(d), DISTINCTCOUNT(rev), DISTINCTCOUNTHLL(rev), PERCENTILEKLL(rev, 99), MODE(disc) "
    "FROM t WHERE q < 25",
    "SELECT disc, DISTINCTCOUNTTHETA(rev), LASTWITHTIME(rev, d, 'LONG'), FIRSTWITHTIME(price, yr, 'DOUBLE'), "
    "FREQUENTLONGS(q, 3) FROM t GROUP BY disc ORDER BY disc LIMIT 20",
    "SELECT DISTINCTCOUNTTHETA(rev, 'disc > 5'), DISTINCTSUM(q), DISTINCTAVG(disc), LASTWITHTIME(rev, d, 'LONG') "
    "FROM t",
    "SET maxDenseGroups = 2; SELECT disc, DISTINCTCOUNTTHETA(rev), LASTWITHTIME(rev, d, 'LONG'), MODE(q), "
    "PERCENTILEKLL(rev, 50) FROM t GROUP BY disc ORDER BY disc LIMIT 20",
]


@pytest.mark.parametrize("batching", ["one", "many"])
@pytest.mark.parametrize("sql", DIST_SQL, ids=[s[:60] for s in DIST_SQL])
def test_dist_engine_matches_jax(dist, batching, sql):
    je, sse_ref, pe = dist[batching]
    assert_same_rows(pe.query(sql).rows, dist_reference_rows(je, sse_ref, sql), ordered="ORDER BY" in sql)


def test_mv_forms_raise_naming_item_5():
    """The *MV names resolve to the port's MVAggFunction over the same base
    function as the JAX package's (they no longer raise)."""
    for name in ("countmv", "summv", "minmv", "maxmv", "avgmv", "distinctcountmv"):
        got, want = pf.get_agg_function(name), jf.get_agg_function(name)
        assert isinstance(got, px.MVAggFunction) and isinstance(want, jx.MVAggFunction)
        assert got.name == want.name == name
        assert got.base.name == want.base.name and got.fields == want.fields
        assert (got.mv_input, got.field_kinds, got.vector_fields) == (True, None, True)
    assert isinstance(pf.get_agg_function("distinctcountrawtheta"), px.DistinctCountThetaFunction)
