"""The port's cluster/mview.py against the JAX package's.

Each scenario builds the same source table and view in both packages (the
port's servers on the CPU), refreshes and queries it through the view
manager, and returns the refresh reports, the stale buckets, the
`mv_rewrite` flags, the docs scanned and the rows; they must agree (rows
by `assert_rows_match`: exact cells and types), and each rewritten answer
must equal the source table's answer through the plain broker
(`golden.assert_same_rows`: the view's sums are DOUBLE).

Mirrored: tests/test_mview.py (refresh then rewrite, a stale bucket's
fallback and repair, a filter on a dimension, the shapes that fall back).
Added: a view with no time column (one bucket, the shape chip_smoke.py's
phase 4l runs at full size), the view's segment columns built from object
rows, and the time-column check of create_view.
"""
import numpy as np
import pytest

from golden import assert_same_rows
from test_torch_coordinator import _jax_kill_points, port_state  # noqa: F401  (fixtures)
from test_torch_query import assert_rows_match
from test_torch_rest import both

T0 = 1_700_000_000_000
DAY = 86_400_000
QUERY = "SELECT city, COUNT(*), SUM(v), MAX(v) FROM events GROUP BY city ORDER BY city"


def events_schema(P):
    S = P.S
    return S.Schema("events", [S.FieldSpec("city", S.DataType.STRING),
                               S.FieldSpec("day_ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
                               S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC)])


def add_day(P, coord, name, day, seed, n=500):
    rng = np.random.default_rng(seed)
    d = {"city": rng.choice(["sf", "nyc", "la"], n).astype(object),
         "day_ts": np.full(n, T0 + day * DAY, dtype=np.int64), "v": rng.integers(0, 100, n)}
    coord.add_segment("events", P.B.build_segment(events_schema(P), d, name,
                                                  table_config=coord.tables["events"].config))


def env(P, time_column="day_ts"):
    coord = P.cl.Coordinator(replication=1)
    coord.register_server(P.server("s0"))
    coord.add_table(events_schema(P), P.C.TableConfig(name="events",
                                                     segments=P.C.SegmentsConfig(time_column="day_ts")))
    add_day(P, coord, "d0", day=0, seed=1)
    add_day(P, coord, "d1", day=1, seed=2)
    mgr = P.mview.MaterializedViewManager(coord)
    dims = ["city", "day_ts"] if time_column else ["city"]
    mgr.create_view(P.mview.MaterializedView(name="events_daily", source_table="events", dimensions=dims,
                                             metrics=[("count", "*"), ("sum", "v"), ("max", "v")],
                                             time_column=time_column))
    return coord, mgr


def run(P, mgr, coord, sql):
    """(mv_rewrite, docs scanned, rows) of the view's answer, after holding
    it to the plain broker's."""
    res = mgr.query(sql)
    assert_same_rows(res.rows, P.cl.Broker(coord).query(sql).rows, ordered="ORDER BY" in sql)
    return res.stats.mv_rewrite, res.stats.num_docs_scanned, res.rows


def assert_runs(got, want):
    assert got[:2] == want[:2]
    assert_rows_match(got[2], want[2], ordered=True)


def test_refresh_then_rewrite_matches_source():
    def scenario(P):
        coord, mgr = env(P)
        report = mgr.refresh("events_daily")
        direct = P.cl.Broker(coord).query(QUERY)
        return report, run(P, mgr, coord, QUERY), direct.stats.num_docs_scanned, sorted(
            coord.tables["events_daily"].ideal)

    out = both(scenario)
    report, via_mv, source_docs, segs = out["port"]
    assert len(report["refreshedBuckets"]) == 2 and via_mv[0] is True and via_mv[1] < source_docs
    assert (report, source_docs, segs) == (out["jax"][0], out["jax"][2], out["jax"][3])
    assert_runs(via_mv, out["jax"][1])


def test_stale_bucket_falls_back_then_repairs():
    def scenario(P):
        coord, mgr = env(P)
        mgr.refresh("events_daily")
        add_day(P, coord, "d1b", day=1, seed=3)  # new source rows: bucket 1 stale
        stale = mgr.stale_buckets("events_daily")
        fallback = run(P, mgr, coord, QUERY)
        report = mgr.refresh("events_daily")
        return stale, fallback, report, mgr.stale_buckets("events_daily"), run(P, mgr, coord, QUERY)

    out = both(scenario)
    stale, fallback, report, after, resumed = out["port"]
    assert len(stale) == 1 and fallback[0] is False and len(report["refreshedBuckets"]) == 1
    assert after == [] and resumed[0] is True
    assert (stale, report, after) == (out["jax"][0], out["jax"][2], out["jax"][3])
    assert_runs(fallback, out["jax"][1])
    assert_runs(resumed, out["jax"][4])


def test_filter_on_dimension_rewrites():
    sql = "SELECT city, SUM(v) FROM events WHERE city IN ('sf', 'la') GROUP BY city ORDER BY city"

    def scenario(P):
        coord, mgr = env(P)
        mgr.refresh("events_daily")
        return run(P, mgr, coord, sql)

    out = both(scenario)
    assert out["port"][0] is True
    assert_runs(out["port"], out["jax"])


@pytest.mark.parametrize("sql", [
    "SELECT city, AVG(v) FROM events GROUP BY city",
    "SELECT city, SUM(v) FROM events WHERE v > 50 GROUP BY city",
    "SELECT v, COUNT(*) FROM events GROUP BY v",
    "SELECT COUNT(*) FROM events",
    "SELECT city, SUM(v) FILTER (WHERE city = 'sf') FROM events GROUP BY city",
], ids=["avg_not_stored", "filter_on_metric", "group_on_metric", "no_group_by", "filtered_agg"])
def test_unmatched_shapes_fall_back(sql):
    def scenario(P):
        coord, mgr = env(P)
        mgr.refresh("events_daily")
        rewritten = mgr.rewrite(P.parse(sql))
        res = mgr.query(sql)
        assert_same_rows(res.rows, P.cl.Broker(coord).query(sql).rows)
        return rewritten is None, res.stats.mv_rewrite, sorted(map(tuple, res.rows))

    out = both(scenario)
    assert out["port"][:2] == out["jax"][:2] == (True, False)
    assert_rows_match(out["port"][2], out["jax"][2], ordered=True)


def test_view_without_time_column():
    """One bucket over the whole table: a new source segment stales it; the
    view's segment holds object-built dimension columns with the JAX
    package's dictionary."""

    def scenario(P):
        coord, mgr = env(P, time_column=None)
        report = mgr.refresh("events_daily")
        seg = coord._find_segment_object("events_daily", "events_daily__b0", coord.live)
        cols = {f.name: np.asarray(seg.column(f.name).decoded()).tolist() for f in seg.schema.fields}
        fresh = run(P, mgr, coord, QUERY)
        add_day(P, coord, "d2", day=2, seed=4)
        stale = mgr.stale_buckets("events_daily")
        fallback = run(P, mgr, coord, QUERY)
        mgr.refresh("events_daily")
        return report, cols, seg.num_docs, fresh, stale, fallback, run(P, mgr, coord, QUERY)

    out = both(scenario)
    report, cols, docs, fresh, stale, fallback, resumed = out["port"]
    assert report["refreshedBuckets"] == [0] and docs == 3 and stale == [0]
    assert (fresh[0], fallback[0], resumed[0]) == (True, False, True)
    assert (report, cols, docs, stale) == out["jax"][:3] + (out["jax"][4],)
    for i in (3, 5, 6):
        assert_runs(out["port"][i], out["jax"][i])


def test_create_view_time_column_must_be_a_dimension():
    def scenario(P):
        coord, mgr = env(P)
        with pytest.raises(ValueError) as ei:
            mgr.create_view(P.mview.MaterializedView(name="bad", source_table="events", dimensions=["city"],
                                                     metrics=[("count", "*")], time_column="day_ts"))
        return str(ei.value), sorted(coord.tables)

    out = both(scenario)
    assert out["port"] == out["jax"]
