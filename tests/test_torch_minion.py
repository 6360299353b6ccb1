"""The port's cluster/minion.py against the JAX package's.

Each scenario runs the same minion task in both packages over the same
seeded data (the helpers of tests/test_torch_coordinator.py; the port's
servers on the CPU) and returns the task's report, the coordinator's ideal
state and the broker's answers before and after; they must agree (query
rows by `assert_rows_match`: exact cells and types).  A merged segment's
name carries the wall clock (`{table}_merged_{ms}`), so it is compared by
its form, not its digits.

Mirrored: tests/test_minion.py (merge, rollup, purge, realtime-to-
offline), tests/test_cluster.py's coordinator-owned realtime table drained
by the minion, and tests/test_broker_quota.py's upsert compaction (with a
delete tombstone) and refresh tasks.  Added: the task registry's error.
"""
import numpy as np
import pytest

from test_torch_coordinator import (  # noqa: F401  (fixtures)
    T0, _jax_kill_points, config, ideal, port_state, schema,
)
from test_torch_rest import both
from test_torch_query import assert_rows_match

SQLS = ["SELECT COUNT(*), SUM(v) FROM t",
        "SELECT city, COUNT(*), SUM(v), MAX(v) FROM t GROUP BY city ORDER BY city"]


def cluster(P):
    coord = P.cl.Coordinator(replication=1)
    coord.register_server(P.server("s0"))
    coord.add_table(schema(P), config(P))
    return coord


def answers(broker, sqls=SQLS):
    return [broker.query(sql).rows for sql in sqls]


def assert_same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_rows_match(g, w, ordered=True)


def small_data(n, seed):
    rng = np.random.default_rng(seed)
    return {"city": rng.choice(["sf", "nyc"], n).astype(object), "v": rng.integers(0, 100, n),
            "ts": T0 + rng.integers(0, 1000, n).astype(np.int64)}


def test_merge_small_segments():
    def scenario(P):
        coord = cluster(P)
        cfg = coord.tables["t"].config
        for i in range(5):
            coord.add_segment("t", P.B.build_segment(schema(P), small_data(200, i), f"small{i}", table_config=cfg))
        broker = P.cl.Broker(coord)
        before = answers(broker)
        report = P.minion.MinionTaskManager(coord).run("MergeRollupTask", "t", max_rows_per_segment=1000)
        name = report.pop("outputSegment")
        assert name.startswith("t_merged_") and list(coord.tables["t"].ideal) == [name]
        assert coord.tables["t"].segment_meta[name]["numDocs"] == 1000
        return report, before, answers(broker)

    out = both(scenario)
    for name in ("jax", "port"):
        report, before, after = out[name]
        assert_same_answers(after, before)
    assert out["port"][0] == out["jax"][0] == {"merged": 1, "inputs": [f"small{i}" for i in range(5)],
                                               "outputRows": 1000}
    assert_same_answers(out["port"][2], out["jax"][2])


def test_merge_needs_enough_inputs():
    def scenario(P):
        coord = cluster(P)
        coord.add_segment("t", P.B.build_segment(schema(P), small_data(300, 1), "big", table_config=config(P)))
        coord.add_segment("t", P.B.build_segment(schema(P), small_data(50, 2), "tiny", table_config=config(P)))
        m = P.minion.MinionTaskManager(coord)
        return m.run("MergeRollupTask", "t", max_rows_per_segment=100), sorted(coord.tables["t"].ideal)

    out = both(scenario)
    assert out["port"] == out["jax"] == ({"merged": 0, "inputs": []}, ["big", "tiny"])


def test_rollup_collapses_duplicates():
    def scenario(P):
        coord = cluster(P)
        cfg = coord.tables["t"].config
        d = {"city": np.array(["sf", "sf", "nyc", "sf"], dtype=object), "v": np.array([1, 2, 3, 4]),
             "ts": np.array([100, 100, 100, 200], dtype=np.int64)}
        coord.add_segment("t", P.B.build_segment(schema(P), {k: v[:2] for k, v in d.items()}, "a", table_config=cfg))
        coord.add_segment("t", P.B.build_segment(schema(P), {k: v[2:] for k, v in d.items()}, "b", table_config=cfg))
        report = P.minion.MinionTaskManager(coord).run("MergeRollupTask", "t", rollup=True)
        report.pop("outputSegment")
        rows = P.cl.Broker(coord).query("SELECT city, ts, SUM(v) FROM t GROUP BY city, ts ORDER BY city, ts").rows
        return report, rows

    out = both(scenario)
    assert out["port"][0] == out["jax"][0] and out["port"][0]["outputRows"] == 3
    assert_rows_match(out["port"][1], out["jax"][1], ordered=True)
    assert [tuple(r) for r in out["port"][1]] == [("nyc", 100, 3.0), ("sf", 100, 3.0), ("sf", 200, 4.0)]


def test_purge_rows():
    def scenario(P):
        coord = cluster(P)
        d = small_data(500, 9)
        coord.add_segment("t", P.B.build_segment(schema(P), d, "seg", table_config=config(P)))
        report = P.minion.MinionTaskManager(coord).run("PurgeTask", "t", purge_fn=lambda row: row["city"] == "nyc")
        broker = P.cl.Broker(coord)
        return report, sorted(coord.tables["t"].ideal), answers(broker), broker.query(
            "SELECT COUNT(*) FROM t WHERE city = 'nyc'").rows, int((d["city"] != "nyc").sum())

    out = both(scenario)
    report, names, after, nyc, keep = out["port"]
    assert report == out["jax"][0] == {"purgedRows": 500 - keep, "rebuiltSegments": ["seg_purged"]}
    assert names == ["seg_purged"] and after[0][0][0] == keep and nyc[0][0] == 0
    assert_same_answers(after, out["jax"][2])


def test_purge_needs_a_function():
    def scenario(P):
        with pytest.raises(ValueError) as ei:
            P.minion.MinionTaskManager(cluster(P)).run("PurgeTask", "t")
        return str(ei.value)

    out = both(scenario)
    assert out["port"] == out["jax"]


def test_unknown_task():
    def scenario(P):
        with pytest.raises(ValueError) as ei:
            P.minion.MinionTaskManager(cluster(P)).run("NoSuchTask", "t")
        return str(ei.value)

    out = both(scenario)
    assert out["port"] == out["jax"] and "unknown minion task" in out["port"]


def _stream_config(P, name="t", rows=50, **kw):
    return P.C.TableConfig(name=name, segments=P.C.SegmentsConfig(time_column="ts"),
                           stream=P.C.StreamConfig(stream_type="memory", max_rows_per_segment=rows), **kw)


def test_realtime_to_offline(tmp_path):
    def scenario(P):
        stream = P.R.InMemoryStream(1)
        mgr = P.R.RealtimeTableDataManager(schema(P), _stream_config(P), str(tmp_path / P.name), stream=stream)
        stream.publish_many([{"city": "sf", "v": i, "ts": T0 + i} for i in range(120)], partition=0)
        mgr.consume_all()
        assert len(mgr.sealed[0]) == 2
        coord = P.cl.Coordinator(replication=1)
        coord.register_server(P.server("s0"))
        minion = P.minion.MinionTaskManager(coord)
        report = minion.run("RealtimeToOfflineSegmentsTask", "t", realtime_manager=mgr, window_end_ms=T0 + 200)
        left = len(mgr.sealed[0])
        rows = P.cl.Broker(coord).query(f"SELECT COUNT(*), SUM(v) FROM {report['offlineTable']}").rows
        again = minion.run("RealtimeToOfflineSegmentsTask", "t", realtime_manager=mgr, window_end_ms=T0 + 400)
        return report, left, rows, again, ideal(coord, report["offlineTable"])

    out = both(scenario)
    report, left, rows, again, placed = out["port"]
    assert len(report["moved"]) == 2 and left == 0 and rows[0][0] == 100 and again["moved"] == []
    assert (report, left, again, placed) == (out["jax"][0], out["jax"][1], out["jax"][3], out["jax"][4])
    assert_rows_match(rows, out["jax"][2], ordered=True)


def test_realtime_table_in_cluster_drained(tmp_path):
    """The broker serves a coordinator-owned realtime table's sealed and
    consuming segments; RealtimeToOffline moves the sealed ones, and the
    realtime and offline tables together keep every row, none twice."""

    def scenario(P):
        coord = P.cl.Coordinator(replication=1)
        coord.register_server(P.server("s0"))
        stream = P.R.InMemoryStream(1)
        mgr = coord.add_realtime_table(schema(P, "rt"), _stream_config(P, "rt", rows=40), str(tmp_path / P.name),
                                       stream=stream)
        stream.publish_many([{"city": ["sf", "nyc"][i % 2], "v": i, "ts": T0 + i} for i in range(100)], partition=0)
        consumed = coord.run_realtime_consumption()
        broker = P.cl.Broker(coord)
        sql = "SELECT city, COUNT(*), SUM(v) FROM rt GROUP BY city ORDER BY city"
        before = broker.query(sql).rows
        report = P.minion.MinionTaskManager(coord).run("RealtimeToOfflineSegmentsTask", "rt", realtime_manager=mgr,
                                                       window_end_ms=T0 + 200)
        rt = broker.query(sql).rows
        off = broker.query(sql.replace("FROM rt", f"FROM {report['offlineTable']}")).rows
        return consumed, before, report, rt, off

    out = both(scenario)
    consumed, before, report, rt, off = out["port"]
    assert consumed == 100 and len(report["moved"]) == 2 and report == out["jax"][2]
    assert {r[0]: (r[1], r[2]) for r in before} == {
        "nyc": (50, sum(i for i in range(100) if i % 2)), "sf": (50, sum(i for i in range(100) if i % 2 == 0))}
    assert sum(r[1] for r in off) == 80 and sum(r[1] for r in rt) == 20  # the consuming tail stays realtime
    both_parts = {c: (0, 0) for c in ("nyc", "sf")}
    for r in list(rt) + list(off):
        both_parts[r[0]] = (both_parts[r[0]][0] + r[1], both_parts[r[0]][1] + r[2])
    assert both_parts == {r[0]: (r[1], r[2]) for r in before}
    for i in (1, 3, 4):
        assert_rows_match(out["port"][i], out["jax"][i], ordered=True)


def _upsert_manager(P, d, rows, seal_rows, delete=False):
    S, C = P.S, P.C
    fields = [S.FieldSpec("oid", S.DataType.STRING), S.FieldSpec("amount", S.DataType.DOUBLE, role=S.FieldRole.METRIC)]
    if delete:
        fields.append(S.FieldSpec("deleted", S.DataType.BOOLEAN))
    fields.append(S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME))
    sch = S.Schema("o", fields, primary_key_columns=["oid"])
    cfg = C.TableConfig("o", segments=C.SegmentsConfig(time_column="ts"),
                        stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=seal_rows),
                        upsert=C.UpsertConfig(mode="FULL", comparison_column="ts",
                                              **({"delete_record_column": "deleted"} if delete else {})))
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(sch, cfg, str(d), stream=stream)
    stream.publish_many(rows, partition=0)
    mgr.consume_all()
    eng = P.engine()
    eng.register_table(sch, cfg)
    eng.attach_realtime("o", mgr)
    return stream, mgr, eng


def _sorted_rows(res):
    return sorted((r[0], float(r[1])) for r in res.rows)


def test_upsert_compaction_drops_invalidated_rows(tmp_path):
    def scenario(P):
        rows = [{"oid": f"k{i % 5}", "amount": float(i), "ts": 1000 + i} for i in range(30)]
        stream, mgr, eng = _upsert_manager(P, tmp_path / P.name, rows, seal_rows=10)
        before = _sorted_rows(eng.query("SELECT oid, amount FROM o LIMIT 10"))
        report = P.minion.MinionTaskManager(P.cl.Coordinator(replication=1)).upsert_compact("o", realtime_manager=mgr)
        masks = [bool(np.asarray(s.valid_docs).all()) for segs in mgr.sealed.values() for s in segs]
        after = _sorted_rows(eng.query("SELECT oid, amount FROM o LIMIT 10"))
        stream.publish({"oid": "k0", "amount": 999.0, "ts": 99999}, partition=0)
        mgr.consume_all()
        k0 = eng.query("SELECT amount FROM o WHERE oid = 'k0' LIMIT 2").rows
        docs = sorted((pk, loc.segment, loc.doc) for pk, loc in mgr.upsert.pk_map.items())
        return report, masks, before, after, [float(r[0]) for r in k0], docs

    out = both(scenario)
    report, masks, before, after, k0, docs = out["port"]
    assert report["compacted"] and report["rowsDropped"] > 0 and all(masks)
    assert before == after and k0 == [999.0]
    assert out["port"] == out["jax"]


def test_upsert_compaction_with_delete_tombstone(tmp_path):
    def scenario(P):
        rows = [{"oid": f"k{i % 4}", "amount": float(i), "deleted": False, "ts": 100 + i} for i in range(7)]
        rows.append({"oid": "k1", "amount": 0.0, "deleted": True, "ts": 200})
        rows += [{"oid": f"k{i % 4}", "amount": 50.0 + i, "deleted": False, "ts": 300 + i} for i in range(4)]
        stream, mgr, eng = _upsert_manager(P, tmp_path / P.name, rows, seal_rows=8, delete=True)
        report = P.minion.MinionTaskManager(P.cl.Coordinator(replication=1)).upsert_compact(
            "o", realtime_manager=mgr, invalid_threshold=0.01)
        loc = mgr.upsert.pk_map[("k1",)]
        stream.publish({"oid": "k1", "amount": 77.0, "deleted": False, "ts": 999}, partition=0)
        mgr.consume_all()
        return report, (loc.doc == -1 or not loc.deleted), dict(_sorted_rows(eng.query(
            "SELECT oid, amount FROM o LIMIT 10")))

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1] and out["port"][2] == {"k0": 50.0, "k1": 77.0, "k2": 52.0, "k3": 53.0}


def test_refresh_segment_picks_up_new_index():
    def scenario(P):
        coord = cluster(P)
        cfg = coord.tables["t"].config
        coord.add_segment("t", P.B.build_segment(schema(P), small_data(500, 1), "seg0", table_config=cfg))
        broker = P.cl.Broker(coord)
        before = answers(broker)
        coord.tables["t"].config.indexing = P.C.IndexingConfig(inverted_index_columns=["city"])
        report = P.minion.MinionTaskManager(coord).run("RefreshSegmentTask", "t")
        seg = coord._find_segment_object("t", "seg0", coord.live)
        return report, before, answers(broker), sorted(seg.indexes.get("inverted", {})), broker.query(
            "SELECT COUNT(*) FROM t WHERE city = 'sf'").rows

    out = both(scenario)
    report, before, after, inverted, sf = out["port"]
    assert report == out["jax"][0] == {"refreshed": ["seg0"]} and inverted == ["city"] == out["jax"][3]
    assert_same_answers(after, before)
    assert_same_answers(after, out["jax"][2])
    assert_rows_match(sf, out["jax"][4], ordered=True)
