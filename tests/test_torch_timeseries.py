"""The port's timeseries engine against the JAX package's.

tests/test_timeseries.py's table (20,000 rows over an hour, tags city and
host, a LONG metric) goes into the JAX QueryEngine and, in the port, into
both QueryEngine(device="cpu") and DistributedEngine(device="cpu") over a
one-shard StackedTable.  Each case of tests/test_timeseries.py runs its
pipeline through the JAX TimeSeriesEngine and through the port's over both
port engines; the series must have the same tags and the same values, and
equal the test file's python golden.  The fetch's bucket key
`(ts - start) - MOD(ts - start, step)` is a computed key, so on the port it
goes through the fused scan's plain version here (and the CUDA kernel on the
card).

Tolerance: the series hold integer sums and maxima as floats, so equality
is exact; NaN marks an empty bucket in both (compared with rtol 1e-9
otherwise, as for any float series).
"""
import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.timeseries import TimeBuckets as JaxBuckets
from pinot_tpu.timeseries import TimeSeriesEngine as JaxTS
from pinot_tpu.timeseries import parse_pipeline as jax_pipeline

from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.timeseries import (
    FetchNode,
    SeriesAggregateNode,
    TimeBuckets,
    TimeSeriesEngine,
    TransformNode,
    parse_pipeline,
)

T0 = 1_700_000_000_000
MIN = 60_000
N = 20_000
RTOL = 1e-9


def _schema(S):
    return S.Schema("m", [
        S.FieldSpec("city", S.DataType.STRING),
        S.FieldSpec("host", S.DataType.STRING),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
        S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
    ])


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(71)
    data = {
        "city": rng.choice(["sf", "nyc"], N).astype(object),
        "host": rng.choice(["h1", "h2", "h3"], N).astype(object),
        "v": rng.integers(0, 100, N),
        "ts": T0 + rng.integers(0, 60 * MIN, N).astype(np.int64),
    }
    je = JaxEngine()
    je.register_table(_schema(jax_schema))
    je.add_segment("m", jax_build(_schema(jax_schema), dict(data), "s0"))
    pe = PortEngine(device="cpu")
    pe.register_table(_schema(port_schema))
    pe.add_segment("m", port_build(_schema(port_schema), dict(data), "s0"))
    pd = PortDist(device="cpu", hbm_cache_bytes=0)
    pd.register_table("m", PortStacked.build(_schema(port_schema), dict(data), num_shards=1))
    return JaxTS(je), {"segment": TimeSeriesEngine(pe), "distributed": TimeSeriesEngine(pd)}, data


def _golden(data, tags, buckets, reduce="sum", pred=None):
    """tests/test_timeseries.py's python golden."""
    out = {}
    for i in range(N):
        if pred is not None and not pred(i):
            continue
        b = buckets.bucket_of(data["ts"][i])
        if not (0 <= b < buckets.num):
            continue
        key = tuple(data[t][i] for t in tags)
        out.setdefault(key, {}).setdefault(b, []).append(int(data["v"][i]))
    series = {}
    for key, per in out.items():
        arr = np.full(buckets.num, np.nan)
        for b, vals in per.items():
            arr[b] = sum(vals) if reduce == "sum" else max(vals)
        series[key] = arr
    return series


def _same_series(a, b):
    return np.allclose(a, b, rtol=RTOL, atol=0.0, equal_nan=True)


CASES = {
    # name: (pipeline, (start, step, num), golden tags, reduce, predicate, scale)
    "bucketed_fetch": ("fetch table=m value=v agg=sum tags=city time=ts", (T0, 5 * MIN, 12), ["city"], "sum", None,
                       1.0),
    "fetch_with_filter": ("fetch table=m value=v agg=sum filter=\"city = 'sf'\" tags=city time=ts",
                          (T0, 10 * MIN, 6), ["city"], "sum", "sf", 1.0),
    "partial_window": ("fetch table=m value=v agg=max tags=host time=ts", (T0, 5 * MIN, 3), ["host"], "max", None,
                       1.0),
    "sum_series_collapses_tags": ("fetch table=m value=v agg=sum tags=city,host time=ts | sumSeries city",
                                  (T0, 5 * MIN, 12), ["city"], "sum", None, 1.0),
    "scale_and_global_sum": ("fetch table=m value=v agg=sum tags=city time=ts | sumSeries | scale 2",
                             (T0, 15 * MIN, 4), [], "sum", None, 2.0),
}


@pytest.mark.parametrize("engine", ["segment", "distributed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax_and_golden(env, case, engine):
    jts, ports, data = env
    text, (start, step, num), tags, reduce, pred, scale = CASES[case]
    jblock = jts.execute(jax_pipeline(text), JaxBuckets(start, step, num))
    pblock = ports[engine].execute(parse_pipeline(text), TimeBuckets(start, step, num))
    assert pblock.tag_names == jblock.tag_names
    assert set(pblock.series) == set(jblock.series)
    for key in jblock.series:
        assert _same_series(pblock.series[key], jblock.series[key]), key
    golden = _golden(data, tags, TimeBuckets(start, step, num), reduce=reduce,
                     pred=(lambda i: data["city"][i] == pred) if pred else None)
    assert set(pblock.series) == set(golden)
    for key in golden:
        assert _same_series(pblock.series[key], golden[key] * scale), key


def test_series_combinators_match_jax(env):
    jts, ports, _data = env
    b = (T0, 10 * MIN, 6)
    for op in ("sumSeries", "avgSeries", "maxSeries", "minSeries"):
        text = f"fetch table=m value=v agg=sum tags=city,host time=ts | {op} host | offset 1.5"
        jblock = jts.execute(jax_pipeline(text), JaxBuckets(*b))
        pblock = ports["segment"].execute(parse_pipeline(text), TimeBuckets(*b))
        assert set(pblock.series) == set(jblock.series)
        for key in jblock.series:
            assert _same_series(pblock.series[key], jblock.series[key]), (op, key)


LO_PIPELINE = ("fetch table=lineorder value=lo_revenue agg=sum tags=lo_discount time=lo_orderdate "
               "filter='lo_quantity < 25' | sumSeries | scale 2")


def _lo_schema(S):
    return S.Schema("lineorder", [
        S.FieldSpec("lo_orderdate", S.DataType.INT),
        S.FieldSpec("lo_quantity", S.DataType.INT),
        S.FieldSpec("lo_discount", S.DataType.INT),
        S.FieldSpec("lo_revenue", S.DataType.LONG, role=S.FieldRole.METRIC),
    ])


def test_lineorder_fetch_takes_the_fused_scan(monkeypatch):
    """The card's timeseries query at a small size: SSB lineorder days as
    the time column (2406 values), buckets of 30 days, tags lo_discount.
    Its bucket key `(d - start) - MOD(d - start, 30)` is bounded, so,
    planned for the kernel backend, each port engine's group-by reaches
    fused_scan.fused_group_tables (its plain version here) once a segment
    with an int32 computed key; the series equal the JAX package's and a
    numpy golden."""
    from pinot_tpu_torch.query import planner as port_planner

    from test_torch_query import spy_kernel_calls

    rng = np.random.default_rng(5)
    n = 30_000
    data = {"lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64)}
    parts = [{k: v[i::2] for k, v in data.items()} for i in range(2)]
    je = JaxEngine()
    je.register_table(_lo_schema(jax_schema))
    pe = PortEngine(device="cpu")
    pe.register_table(_lo_schema(port_schema))
    for i, d in enumerate(parts):
        je.add_segment("lineorder", jax_build(_lo_schema(jax_schema), dict(d), f"s{i}"))
        pe.add_segment("lineorder", port_build(_lo_schema(port_schema), dict(d), f"s{i}"))
    pd = PortDist(device="cpu", hbm_cache_bytes=0)
    pd.register_table("lineorder", PortStacked.build(_lo_schema(port_schema), dict(data), num_shards=1))
    b = (19920101, 30, 81)
    want = JaxTS(je).execute(jax_pipeline(LO_PIPELINE), JaxBuckets(*b)).series
    m = data["lo_quantity"] < 25
    golden = 2.0 * np.bincount((data["lo_orderdate"][m] - 19920101) // 30, weights=data["lo_revenue"][m],
                               minlength=81)
    assert list(want) == [()] and _same_series(want[()], golden)
    calls = spy_kernel_calls(monkeypatch, port_planner)
    for label, eng, launches in (("segment", pe, 2), ("distributed", pd, 1)):
        calls.clear()
        got = TimeSeriesEngine(eng).execute(parse_pipeline(LO_PIPELINE), TimeBuckets(*b)).series
        assert len(calls) == launches, label
        assert all(c["variant"].startswith("i32/") for c in calls), calls
        assert list(got) == [()] and _same_series(got[()], want[()]), label


def test_plan_tree_and_parse_errors():
    node = parse_pipeline("fetch table=m value=v agg=count filter='v > 3' tags=a,b time=t | maxSeries a | scale 3")
    assert isinstance(node, TransformNode) and node.arg == 3.0
    assert isinstance(node.child, SeriesAggregateNode) and node.child.op == "max"
    fetch = node.child.child
    assert isinstance(fetch, FetchNode)
    assert (fetch.agg, fetch.filter_sql, fetch.group_tags, fetch.time_column) == ("count", "v > 3", ("a", "b"), "t")
    for bad in ("sumSeries", "fetch value=v", "fetch table=m value=v | rate 5"):
        with pytest.raises(ValueError):
            parse_pipeline(bad)
    with pytest.raises(TypeError):
        TimeSeriesEngine(None).execute(object(), TimeBuckets(0, 1, 1))


def test_timestamps():
    b = TimeBuckets(T0, MIN, 5)
    assert b.timestamps() == [T0 + i * MIN for i in range(5)]
    assert b.end_ms == T0 + 5 * MIN
    assert b.bucket_of(T0 + 2 * MIN + 1) == 2


@pytest.mark.parametrize("expr", ["(x - 7) - MOD(x - 7, 30)", "x - MOD(x, 25)", "x - MOD(x, 1)",
                                  "x - MOD(y, 30)"])
def test_bucket_key_groups_match_jax(expr):
    """A `x - MOD(x, k)` group key takes only multiples of k (x of either
    sign): the port's dense key divides by k, and the rows equal the JAX
    package's; `x - MOD(y, k)` keeps a step of 1."""
    from pinot_tpu_torch.query import planner as port_planner
    from pinot_tpu_torch.sql.parser import parse_query as port_parse

    from test_torch_sketches import assert_same_rows

    rng = np.random.default_rng(9)
    n = 5000
    data = {"x": rng.integers(-400, 900, n).astype(np.int32), "y": rng.integers(0, 50, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int64)}

    def schema(S):
        return S.Schema("b", [S.FieldSpec("x", S.DataType.INT), S.FieldSpec("y", S.DataType.INT),
                              S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC)])

    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(schema(jax_schema))
    pe.register_table(schema(port_schema))
    for i in range(2):
        part = {k: a[i::2] for k, a in data.items()}
        je.add_segment("b", jax_build(schema(jax_schema), dict(part), f"s{i}"))
        pe.add_segment("b", port_build(schema(port_schema), dict(part), f"s{i}"))
    sql = f"SELECT {expr}, COUNT(*), SUM(v) FROM b WHERE y < 40 GROUP BY {expr} ORDER BY {expr} LIMIT 10000"
    assert_same_rows(pe.query(sql).rows, je.query(sql).rows, ordered=True)
    plan = port_planner.plan_segment(port_parse(sql), pe.tables["b"].segments[0], pe.device)
    (gd,) = plan.group_dims
    k = {"(x - 7) - MOD(x - 7, 30)": 30, "x - MOD(x, 25)": 25}.get(expr, 1)
    assert gd.kind == "expr" and gd.step == k and gd.base % k == 0
