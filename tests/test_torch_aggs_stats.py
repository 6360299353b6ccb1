"""The port's statistics long tail (HISTOGRAM, COVAR_POP/SAMP, CORR,
EXPR_MIN/MAX and their ARG_ aliases, FREQUENTSTRINGS, the integer tuple
sketches) against the JAX package.

Partials on the same numpy inputs (measure ties included), the tuple
sketch's pairwise merge, and SQL through both packages' engines as in
test_torch_aggs_extra.py.  The funnel family has its own file
(test_torch_funnel.py).

Tolerances: integer results and every partial field identical (histograms,
KMV rows and payloads, (m, v) pairs, counts); the float64 statistics and
their finals to rtol 1e-9.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from pinot_tpu.query import functions as jf
from pinot_tpu.query import sketches as jsk

from pinot_tpu_torch.query import functions as pf
from pinot_tpu_torch.query import sketches as psk

from test_torch_sketches import (
    RTOL,
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


_STRINGS = np.asarray(["a", "bb", "c", "dd", "e"], dtype=object)
PARTIAL_CASES = {
    "histogram/equal": ("histogram", (0, 1000, 10), None, "one"),
    "histogram/edges": ("histogram", ("0,1,10,100,1000",), None, "one"),
    "covar_pop": ("covar_pop", (), None, "pair"),
    "covar_samp": ("covar_samp", (), None, "pair"),
    "corr": ("corr", (), None, "pair"),
    "exprmax": ("exprmax", (), None, "ties"),
    "exprmin": ("exprmin", (), None, "ties"),
    "frequentstrings": ("frequentstrings", (2,), dict(kind="dict", domain=5, dict_values=_STRINGS), "codes"),
    "tuple/distinct": ("distinctcounttuplesketch", (), None, "tuple"),
    "tuple/sum": ("sumvaluesintegersumtuplesketch", (), None, "tuple"),
    "tuple/avg": ("avgvalueintegersumtuplesketch", (), None, "tuple"),
}


def _inputs(shape, n=6000, seed=9):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.85
    keys = rng.integers(0, 6, n).astype(np.int32)
    if shape == "one":
        vals = rng.integers(-20, 1100, n).astype(np.int64)
    elif shape == "pair":
        vals = (rng.integers(-1000, 1000, n).astype(np.int64), rng.standard_normal(n) * 50)
    elif shape == "ties":  # (projection, measure) with many tied measures
        vals = (rng.standard_normal(n), rng.integers(0, 30, n).astype(np.int32))
    elif shape == "codes":
        vals = rng.integers(0, 5, n).astype(np.int32)
    else:  # tuple: (key values, int payload); few keys so groups saturate K
        vals = (rng.integers(0, 20000, n).astype(np.int64), rng.integers(-5, 50, n).astype(np.int64))
    return vals, mask, keys


def _finals_equal(pfn, jfn, pp, jp):
    got = pfn.final({k: np.asarray(v) for k, v in pp.items()})
    want = jfn.final({k: np.asarray(v) for k, v in jp.items()})
    got, want = np.atleast_1d(np.asarray(got, dtype=object)), np.atleast_1d(np.asarray(want, dtype=object))
    for a, b in zip(got, want):
        if isinstance(a, (float, np.floating)) and isinstance(b, (float, np.floating)):
            assert (np.isnan(a) and np.isnan(b)) or np.isclose(a, b, rtol=RTOL, atol=0), (a, b)
        else:
            assert a == b, (a, b)


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
@pytest.mark.parametrize("grouped", [False, True])
def test_partials_match_jax(case, grouped):
    name, lits, binding, shape = PARTIAL_CASES[case]
    jfn, pfn = _pair(name, lits, binding)
    vals, mask, keys = _inputs(shape)
    if grouped:
        jp = jfn.partial_grouped(as_jax(vals), jnp.asarray(mask), jnp.asarray(keys), 6)
        pp = pfn.partial_grouped(as_port(vals), torch.from_numpy(mask), torch.from_numpy(keys), 6)
    else:
        jp = jfn.partial(as_jax(vals), jnp.asarray(mask))
        pp = pfn.partial(as_port(vals), torch.from_numpy(mask))
    if shape == "pair":
        # float64 sums: the packages add in different orders
        assert set(jp) == set(pp)
        for f in jp:
            np.testing.assert_allclose(pp[f].numpy(), np.asarray(jp[f]), rtol=RTOL, atol=0)
    else:
        assert_same_partial(jp, pp)
    _finals_equal(pfn, jfn, pp, jp)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_tuple_merge_matches_jax(kind):
    jfn, pfn = _pair("sumvaluesintegersumtuplesketch")
    parts = []
    for seed in (1, 2):
        vals, mask, keys = _inputs("tuple", seed=seed)
        jp = jfn.partial_grouped(as_jax(vals), jnp.asarray(mask), jnp.asarray(keys), 6)
        pp = pfn.partial_grouped(as_port(vals), torch.from_numpy(mask), torch.from_numpy(keys), 6)
        parts.append(({k: np.asarray(v) for k, v in jp.items()}, pp))
    want = jfn.merge(parts[0][0], parts[1][0])
    pa, pb = parts[0][1], parts[1][1]
    if kind == "numpy":
        pa, pb = ({k: v.numpy() for k, v in p.items()} for p in (pa, pb))
    got = pfn.merge(pa, pb)
    assert isinstance(got["kmv"], torch.Tensor if kind == "torch" else np.ndarray)
    assert_same_partial(want, got)


def test_frequentstrings_bind_reduce_matches_jax():
    from pinot_tpu.sql.parser import parse_query as jparse

    from pinot_tpu_torch.sql.parser import parse_query as pparse

    sql = "SELECT FREQUENTSTRINGS(city, 2) FROM t"
    jctx, pctx = jparse(sql), pparse(sql)
    for ctx, fmod in ((jctx, jf), (pctx, pf)):
        with pytest.raises(NotImplementedError, match="__dictvals__"):
            fmod.for_spec(ctx.aggregations[0]).bind_reduce(ctx, ctx.aggregations[0])
        ctx.options["__dictvals__city"] = _STRINGS
    jb = jf.for_spec(jctx.aggregations[0]).bind_reduce(jctx, jctx.aggregations[0])
    pb = pf.for_spec(pctx.aggregations[0]).bind_reduce(pctx, pctx.aggregations[0])
    hist = {"hist": np.asarray([[3, 9, 9, 0, 1]]), "lo": np.zeros(1)}
    assert list(pb.final(hist)) == list(jb.final(hist)) == [["bb", "c"]]


SSE_SQL = [
    "SELECT HISTOGRAM(v, 0, 1000, 10), HISTOGRAM(day, '0,10,100,365'), HISTOGRAM(price, 'ARRAY[0, 50, 100]') FROM t",
    "SELECT COVAR_POP(v, day), COVAR_SAMP(v, price), CORR(v, day), COVARPOP(big, v), COVARSAMP(day, year) FROM t",
    "SELECT EXPR_MAX(v, day), EXPR_MIN(day, v), ARG_MAX(price, year), ARGMIN(big, year), EXPRMAX(v, year) FROM t",
    "SELECT city, COVAR_POP(v, day), CORR(big, price), EXPR_MAX(v, year), EXPR_MIN(v, year), "
    "HISTOGRAM(v, -50, 1000, 7) FROM t GROUP BY city ORDER BY city LIMIT 20",
    "SELECT FREQUENTSTRINGS(city, 3), FREQUENTSTRINGS(tag) FROM t WHERE year > 2003",
    "SELECT DISTINCTCOUNTTUPLESKETCH(v, day), SUMVALUESINTEGERSUMTUPLESKETCH(v, day), "
    "AVGVALUEINTEGERSUMTUPLESKETCH(big, year) FROM t",
    "SELECT year, DISTINCTCOUNTTUPLESKETCH(v, day), SUMVALUESINTEGERSUMTUPLESKETCH(day, v), "
    "ARG_MIN(v, day) FROM t GROUP BY year ORDER BY year LIMIT 50",
    "SET maxDenseGroups = 4; SELECT year, day, COVAR_POP(v, big), EXPR_MAX(price, v), HISTOGRAM(v, 0, 1000, 4) "
    "FROM t GROUP BY year, day ORDER BY year, day LIMIT 40",
]


@pytest.mark.parametrize("layout", ["one", "multi"])
@pytest.mark.parametrize("sql", SSE_SQL, ids=[s[:60] for s in SSE_SQL])
def test_segment_engine_matches_jax(sse, layout, sql):
    je, pe = sse[layout]
    try:
        want = je.query(sql).rows
    except NotImplementedError as e:  # FREQUENTSTRINGS over MIXED dictionaries
        with pytest.raises(NotImplementedError) as got:
            pe.query(sql)
        assert str(got.value) == str(e)
        return
    assert_same_rows(pe.query(sql).rows, want, ordered="ORDER BY" in sql)


DIST_SQL = [
    "SELECT disc, DISTINCTCOUNTTHETA(rev), COVAR_POP(q, rev), CORR(q, rev), EXPR_MAX(d, rev), "
    "LASTWITHTIME(rev, d, 'LONG'), HISTOGRAM(q, 0, 50, 10) FROM t GROUP BY disc ORDER BY disc LIMIT 20",
    "SELECT FREQUENTSTRINGS(city, 2), DISTINCTCOUNTTUPLESKETCH(rev, q), EXPR_MIN(d, rev), COVAR_SAMP(rev, price) "
    "FROM t WHERE q < 40",
    "SET maxDenseGroups = 2; SELECT disc, CORR(q, rev), EXPR_MAX(d, rev), HISTOGRAM(rev, '100,1000,100000,1000000'), "
    "FREQUENTSTRINGS(city, 1), AVGVALUEINTEGERSUMTUPLESKETCH(rev, q) FROM t GROUP BY disc ORDER BY disc LIMIT 20",
]


@pytest.mark.parametrize("batching", ["one", "many"])
@pytest.mark.parametrize("sql", DIST_SQL, ids=[s[:60] for s in DIST_SQL])
def test_dist_engine_matches_jax(dist, batching, sql):
    je, sse_ref, pe = dist[batching]
    assert_same_rows(pe.query(sql).rows, dist_reference_rows(je, sse_ref, sql), ordered="ORDER BY" in sql)
