"""Realtime tables of the port against the JAX package's.

Each scenario is written once over a package namespace (`pkg("jax")` or
`pkg("port")`: schema, config, stream, manager and engine classes) and run
in both packages on the same rows, made from a numpy seed; what it returns
(query rows, row counts, offsets) must agree.  Integer cells are held
exactly and float cells to rtol 1e-9 (`assert_same_rows`); where the JAX
tests compare with sqlite, the port is held to the same golden too.  The
port runs on the CPU (`QueryEngine(device="cpu")`).

Mirrored: tests/test_realtime.py (consume, seal, mixed queries, restart,
interleaved publishes, the JSONL file stream), the MV and snapshot-index
cases of tests/test_realtime_parity.py, and
test_crash_recovery.py::TestSegmentCommitKillPoints at its 10 kill-points
that need no deep store.  Added: partition_of bit parity across key types,
the TailFollower's torn tail and truncation, the config dicts, a superseded
snapshot's device columns, and the cross-package recovery of a data
directory the other package wrote and sealed, both ways.
"""
import json
import os
import types

import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu import realtime as jax_rt
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.realtime import stream as jax_stream
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import filesystem as jax_fs
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.utils import crashpoints as jax_crash
from pinot_tpu.utils import hashing as jax_hashing

from pinot_tpu_torch import realtime as port_rt
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.realtime import stream as port_stream
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import filesystem as port_fs
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.utils import crashpoints as port_crash
from pinot_tpu_torch.utils import hashing as port_hashing

from golden import assert_same_rows as assert_sqlite_rows
from golden import sqlite_from_data
from test_torch_sketches import assert_same_rows  # floats to rtol 1e-9, the rest exact


def pkg(name: str) -> types.SimpleNamespace:
    """One package's realtime surface."""
    if name == "jax":
        S, C, R, crash, fs, engine = jax_schema, jax_config, jax_rt, jax_crash, jax_fs, JaxEngine
    else:
        S, C, R, crash, fs = port_schema, port_config, port_rt, port_crash, port_fs

        def engine():
            return PortEngine(device="cpu")

    return types.SimpleNamespace(name=name, S=S, C=C, R=R, crash=crash, fs=fs, engine=engine,
                                 stream=jax_stream if name == "jax" else port_stream)


PKGS = ("jax", "port")


def run_both(scenario, tmp_path, *args):
    """scenario(P, dir, *args) in each package, each in its own directory."""
    return {name: scenario(pkg(name), str(tmp_path / name), *args) for name in PKGS}


def assert_parity(out, sqlite_rows=None):
    """Both packages' results agree: rows lists by assert_same_rows, other
    values exactly; with sqlite_rows, the port's query rows are held to the
    sqlite golden as well."""
    j, p = out["jax"], out["port"]
    assert set(j) == set(p)
    for k in j:
        if isinstance(j[k], list):
            assert_same_rows(p[k], j[k])
        else:
            assert p[k] == j[k], (k, p[k], j[k])
    for k, want in (sqlite_rows or {}).items():
        assert_sqlite_rows(p[k], want)


def attach(P, schema, cfg, mgr):
    eng = P.engine()
    eng.register_table(schema, cfg)
    eng.attach_realtime(schema.name, mgr)
    return eng


# ---------------------------------------------------------------------------
# the events table of tests/test_realtime.py
# ---------------------------------------------------------------------------
def events_schema(P):
    S = P.S
    return S.Schema(
        name="events",
        fields=[
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("status", S.DataType.STRING),
            S.FieldSpec("clicks", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
        ],
    )


def events_config(P, max_rows=40):
    C = P.C
    return C.TableConfig(
        name="events", stream=C.StreamConfig(stream_type="memory", topic="events", max_rows_per_segment=max_rows)
    )


def event_rows(n, seed=7):
    rng = np.random.default_rng(seed)
    cities = ["nyc", "sf", "tokyo", "lima"]
    statuses = ["ok", "err"]
    return [
        {
            "city": cities[int(rng.integers(0, len(cities)))],
            "status": statuses[int(rng.integers(0, 2))],
            "clicks": int(rng.integers(0, 100)),
            "ts": 1_700_000_000_000 + i * 1000,
        }
        for i in range(n)
    ]


def sqlite_rows(rows, sql, table="events"):
    data = {k: np.array([r[k] for r in rows], dtype=object) for k in rows[0]}
    return sqlite_from_data(table, data).execute(sql).fetchall()


EVENT_QUERIES = {
    "count_sum": "SELECT COUNT(*), SUM(clicks) FROM events",
    "stats": "SELECT COUNT(*), SUM(clicks), MIN(clicks), MAX(clicks) FROM events",
    "by_city": "SELECT city, SUM(clicks) FROM events GROUP BY city",
    "by_status": "SELECT status, COUNT(*) FROM events WHERE clicks > 50 GROUP BY status",
}


def _fresh_rows_before_seal(P, d):
    stream = P.R.InMemoryStream(num_partitions=2)
    mgr = P.R.RealtimeTableDataManager(events_schema(P), events_config(P), d, stream=stream)
    eng = attach(P, events_schema(P), events_config(P), mgr)
    stream.publish_many(event_rows(30), partition=0)  # below the 40-row seal
    mgr.consume_all()
    return {"total": mgr.total_rows, "sealed": len(mgr.sealed[0]),
            "rows": eng.query(EVENT_QUERIES["count_sum"]).rows}


def test_fresh_rows_visible_before_seal(tmp_path):
    out = run_both(_fresh_rows_before_seal, tmp_path)
    assert out["port"]["total"] == 30 and out["port"]["sealed"] == 0
    assert_parity(out, {"rows": sqlite_rows(event_rows(30), EVENT_QUERIES["count_sum"])})


def _seal_and_mixed(P, d):
    stream = P.R.InMemoryStream(num_partitions=2)
    mgr = P.R.RealtimeTableDataManager(events_schema(P), events_config(P), d, stream=stream)
    eng = attach(P, events_schema(P), events_config(P), mgr)
    for i, r in enumerate(event_rows(100)):
        stream.publish(r, partition=i % 2)
    mgr.consume_all()
    out = {"sealed": (len(mgr.sealed[0]), len(mgr.sealed[1])), "total": mgr.total_rows}
    for name in ("stats", "by_city", "by_status"):
        out[name] = eng.query(EVENT_QUERIES[name]).rows
    return out


def test_seal_and_mixed_query(tmp_path):
    out = run_both(_seal_and_mixed, tmp_path)
    assert out["port"]["sealed"] == (1, 1) and out["port"]["total"] == 100
    rows = event_rows(100)
    assert_parity(out, {k: sqlite_rows(rows, EVENT_QUERIES[k]) for k in ("stats", "by_city", "by_status")})


def _sealed_is_durable(P, d):
    stream = P.R.InMemoryStream(num_partitions=2)
    mgr = P.R.RealtimeTableDataManager(events_schema(P), events_config(P), d, stream=stream)
    stream.publish_many(event_rows(45), partition=0)
    mgr.consume_all()
    sealed = mgr.sealed[0][0]
    loaded = type(sealed).load(mgr.segment_dir(sealed.name), verify=True)
    return {"sealed_docs": sealed.num_docs, "dir": os.path.isdir(mgr.segment_dir(sealed.name)),
            "consuming": mgr.managers[0].mutable.num_docs, "name": sealed.name,
            "loaded_clicks": int(loaded.column("clicks").decoded().sum())}


def test_sealed_segment_is_durable_and_indexed(tmp_path):
    out = run_both(_sealed_is_durable, tmp_path)
    assert out["port"]["sealed_docs"] == 40 and out["port"]["dir"] and out["port"]["consuming"] == 5
    assert out["port"]["name"] == "events__0__0"
    assert_parity(out)


def _restart(P, d):
    stream = P.R.InMemoryStream(num_partitions=1)
    rows = event_rows(90)
    mgr = P.R.RealtimeTableDataManager(events_schema(P), events_config(P), d, stream=stream)
    stream.publish_many(rows, partition=0)
    mgr.consume_all()
    before = (len(mgr.sealed[0]), mgr.managers[0].mutable.num_docs)
    del mgr  # a crash: the consuming rows are lost by design
    mgr2 = P.R.RealtimeTableDataManager(events_schema(P), events_config(P), d, stream=stream)
    resumed = (len(mgr2.sealed[0]), mgr2.managers[0].offset, mgr2.managers[0].seq)
    mgr2.consume_all()
    eng = attach(P, events_schema(P), events_config(P), mgr2)
    return {"before": before, "resumed": resumed, "total": mgr2.total_rows,
            "by_city": eng.query("SELECT city, COUNT(*), SUM(clicks) FROM events GROUP BY city").rows}


def test_restart_resumes_from_committed_offset(tmp_path):
    out = run_both(_restart, tmp_path)
    assert out["port"]["before"] == (2, 10)
    assert out["port"]["resumed"] == (2, 80, 2)
    assert out["port"]["total"] == 90
    assert_parity(out, {"by_city": sqlite_rows(event_rows(90),
                                               "SELECT city, COUNT(*), SUM(clicks) FROM events GROUP BY city")})


def _interleaved(P, d):
    stream = P.R.InMemoryStream(num_partitions=1)
    mgr = P.R.RealtimeTableDataManager(events_schema(P), events_config(P, max_rows=25), d, stream=stream)
    eng = attach(P, events_schema(P), events_config(P), mgr)
    rows = event_rows(70)
    out = {}
    for start in range(0, 70, 10):
        stream.publish_many(rows[start:start + 10], partition=0)
        mgr.consume_all()
        out[f"after_{start + 10}"] = eng.query(EVENT_QUERIES["count_sum"]).rows
    return out


def test_publish_while_consuming_interleaved(tmp_path):
    out = run_both(_interleaved, tmp_path)
    rows = event_rows(70)
    assert_parity(out, {f"after_{n}": sqlite_rows(rows[:n], EVENT_QUERIES["count_sum"]) for n in range(10, 71, 10)})


def _jsonl_tail(P, d):
    os.makedirs(d)
    path = os.path.join(d, "in.jsonl")
    rows = event_rows(20)
    with open(path, "w") as f:
        for r in rows[:12]:
            f.write(json.dumps(r) + "\n")
    fs = P.stream.FileStream(path)
    b1 = fs.fetch(0, 8)
    b2 = fs.fetch(b1.next_offset, 100)
    with open(path, "a") as f:
        for r in rows[12:]:
            f.write(json.dumps(r) + "\n")
    b3 = fs.fetch(b2.next_offset, 100)
    return {"b1": (len(b1), b1.next_offset, b1.end_of_partition), "b2": (len(b2), b2.next_offset, b2.end_of_partition),
            "b3": (len(b3), b3.next_offset), "latest": fs.latest_offset(),
            "values": [tuple(sorted(m.value.items())) for m in b1.messages + b2.messages + b3.messages]}


def test_jsonl_tail(tmp_path):
    out = run_both(_jsonl_tail, tmp_path)
    assert out["port"]["b1"] == (8, 8, False) and out["port"]["b2"][0] == 4 and out["port"]["b2"][2]
    assert out["port"]["b3"][0] == 8 and out["port"]["latest"] == 20
    assert_parity(out)


def _file_stream_table(P, d):
    os.makedirs(d)
    path = os.path.join(d, "in.jsonl")
    with open(path, "w") as f:
        for r in event_rows(30):
            f.write(json.dumps(r) + "\n")
    C = P.C
    cfg = C.TableConfig(name="events",
                        stream=C.StreamConfig(stream_type="file", properties={"path": path}, max_rows_per_segment=16))
    mgr = P.R.RealtimeTableDataManager(events_schema(P), cfg, os.path.join(d, "tbl"))
    mgr.consume_all()
    eng = attach(P, events_schema(P), cfg, mgr)
    return {"total": mgr.total_rows, "sealed": len(mgr.sealed[0]), "by_city": eng.query(EVENT_QUERIES["by_city"]).rows}


def test_file_stream_table(tmp_path):
    out = run_both(_file_stream_table, tmp_path)
    assert out["port"]["total"] == 30 and out["port"]["sealed"] == 1
    assert_parity(out, {"by_city": sqlite_rows(event_rows(30), EVENT_QUERIES["by_city"])})


# ---------------------------------------------------------------------------
# tests/test_realtime_parity.py: MV columns and snapshot indexes
# ---------------------------------------------------------------------------
def _mv_schema(P):
    S = P.S
    return S.Schema("events", [
        S.FieldSpec("eid", S.DataType.INT),
        S.FieldSpec("tags", S.DataType.STRING, single_value=False),
        S.FieldSpec("vals", S.DataType.INT, single_value=False),
        S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
    ])


def _mv_ingest(P, d):
    C = P.C
    schema = _mv_schema(P)
    cfg = C.TableConfig("events", segments=C.SegmentsConfig(time_column="ts"),
                        stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=10))
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(schema, cfg, d, stream=stream)
    eng = attach(P, schema, cfg, mgr)
    rows = [{"eid": i, "tags": ["red", "blue"] if i % 2 == 0 else ["green"], "vals": [i, i * 10],
             "ts": 1_700_000_000_000 + i} for i in range(25)]
    stream.publish_many(rows, partition=0)
    mgr.consume_all()
    out = {"red": eng.query("SELECT COUNT(*) FROM events WHERE tags = 'red'").rows,
           "summv": eng.query("SELECT SUMMV(vals) FROM events WHERE eid < 3").rows,
           "by_tag": eng.query("SELECT tags, COUNT(*) FROM events GROUP BY tags").rows}
    stream.publish({"eid": 99, "tags": None, "vals": [1], "ts": 1_700_000_100_000}, partition=0)
    mgr.consume_all()
    out["red_after_empty"] = eng.query("SELECT COUNT(*) FROM events WHERE tags = 'red'").rows
    out["point"] = (tuple(mgr.managers[0].mutable.value_at("tags", 0)), tuple(mgr.managers[0].mutable.value_at("vals", 0)))
    return out


def test_mv_ingest_and_query(tmp_path):
    out = run_both(_mv_ingest, tmp_path)
    assert int(out["port"]["red"][0][0]) == 13 and int(out["port"]["red_after_empty"][0][0]) == 13
    assert float(out["port"]["summv"][0][0]) == sum(i + i * 10 for i in range(3))
    assert out["port"]["point"] == (("red", "blue"), (20, 200))  # the consuming segment's first row: eid 20
    assert_parity(out)


def _snapshot_indexes(P, d):
    S, C = P.S, P.C
    schema = S.Schema("logs", [
        S.FieldSpec("level", S.DataType.STRING),
        S.FieldSpec("msg", S.DataType.STRING),
        S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
    ])
    cfg = C.TableConfig("logs", indexing=C.IndexingConfig(inverted_index_columns=["level"], text_index_columns=["msg"]),
                        segments=C.SegmentsConfig(time_column="ts"),
                        stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=1000))
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(schema, cfg, d, stream=stream)
    eng = attach(P, schema, cfg, mgr)
    stream.publish_many([{"level": ["info", "warn", "error"][i % 3],
                          "msg": f"request {i} failed fast" if i % 3 == 2 else f"request {i} ok", "ts": i}
                         for i in range(60)], partition=0)
    mgr.consume_all()
    r = eng.query("SELECT COUNT(*) FROM logs WHERE level = 'error'")
    r2 = eng.query("SELECT COUNT(*) FROM logs WHERE TEXT_MATCH(msg, 'failed')")
    return {"error": r.rows, "error_uses": r.stats.filter_index_uses, "failed": r2.rows,
            "failed_uses": r2.stats.filter_index_uses}


def test_consuming_snapshot_builds_configured_indexes(tmp_path):
    out = run_both(_snapshot_indexes, tmp_path)
    assert int(out["port"]["error"][0][0]) == 20 and int(out["port"]["failed"][0][0]) == 20
    assert ("level", "inverted") in out["port"]["error_uses"]
    assert ("msg", "text") in out["port"]["failed_uses"]
    assert_parity(out)


# ---------------------------------------------------------------------------
# crash at every seal step (no deep store)
# ---------------------------------------------------------------------------
SEAL_POINTS = [
    "segment.write.after_data_write",
    "segment.write.after_data_replace",
    "segment.write.meta.after_write",
    "segment.write.meta.after_replace",
    "segment.seal.after_build",
    "segment.seal.after_upload",
    "segment.seal.after_swap",
    "realtime.checkpoint.after_write",
    "realtime.checkpoint.after_bak",
    "realtime.checkpoint.after_replace",
]


def _crash_schema(P):
    S = P.S
    return S.Schema("t", [
        S.FieldSpec("city", S.DataType.STRING),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
        S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
    ])


def _crash_rows(n=50, seed=11):
    rng = np.random.default_rng(seed)
    return {"city": rng.choice(["sf", "nyc", "la"], n).astype(object), "v": rng.integers(0, 100, n),
            "ts": 1_700_000_000_000 + rng.integers(0, 86_400_000, n).astype(np.int64)}


def _crash_at(P, d, point):
    schema = _crash_schema(P)
    cfg = P.C.TableConfig(name="t", stream=P.C.StreamConfig(stream_type="memory", max_rows_per_segment=16))
    stream = P.R.InMemoryStream(num_partitions=1)
    rows = _crash_rows()
    for i in range(50):
        stream.publish({k: rows[k][i].item() if isinstance(rows[k][i], np.generic) else rows[k][i] for k in rows},
                       partition=0)
    mgr = P.R.RealtimeTableDataManager(schema, cfg, d, stream=stream)
    P.crash.reset()
    P.crash.arm(point)
    with pytest.raises(P.crash.InjectedCrash):
        mgr.consume_all()
    fired = P.crash.fired[-1][0]
    P.crash.reset()
    mgr2 = P.R.RealtimeTableDataManager(schema, cfg, d, stream=stream)
    mgr2.consume_all()
    eng = attach(P, schema, cfg, mgr2)
    return {"fired": fired, "total": mgr2.total_rows, "sealed": len(mgr2.sealed[0]),
            "v": sum(int(s.column("v").decoded().sum()) for s in mgr2.query_segments()),
            "by_city": eng.query("SELECT city, COUNT(*), SUM(v) FROM t GROUP BY city").rows}


@pytest.mark.parametrize("point", SEAL_POINTS)
def test_crash_at_every_seal_step_loses_nothing(tmp_path, point):
    """Kill the seal/commit protocol at each step: after a restart the table
    holds exactly the published rows in both packages."""
    out = run_both(_crash_at, tmp_path, point)
    rows = _crash_rows()
    assert out["port"]["fired"] == point
    assert out["port"]["total"] == 50 and out["port"]["v"] == int(rows["v"].sum())
    assert_parity(out)


# ---------------------------------------------------------------------------
# host-only parity: hashing, the tail follower, config dicts
# ---------------------------------------------------------------------------
def _keys():
    rng = np.random.default_rng(5)
    keys = [0, 1, -1, 2 ** 31, -(2 ** 63), 2 ** 64 + 3, True, False, 2.0, -0.0, 0.5, 1e300, float("inf"),
            float("nan"), "", "a", "ord17", "naïve ✓", b"", b"\x00\xff", b"abcde", np.int64(7), np.int32(-9),
            np.float64(3.25), np.float32(2.5), np.str_("k9"), (1, "a"), ("x", 2.5, None), None]
    keys += [int(v) for v in rng.integers(-(2 ** 62), 2 ** 62, 200)]
    keys += [f"key{int(v)}" for v in rng.integers(0, 10 ** 9, 200)]
    keys += [bytes(rng.integers(0, 256, int(n)).astype(np.uint8)) for n in rng.integers(0, 13, 100)]
    keys += [float(v) for v in rng.normal(size=100)]
    return keys


@pytest.mark.parametrize("num_partitions", [1, 2, 3, 7, 16])
def test_partition_of_is_bit_identical(num_partitions):
    for k in _keys():
        cb = jax_hashing.canonical_bytes(k)
        assert port_hashing.canonical_bytes(k) == cb, k
        assert port_hashing.murmur2(cb) == jax_hashing.murmur2(cb), k
        assert port_hashing.partition_of(k, num_partitions) == jax_hashing.partition_of(k, num_partitions), k


def test_murmur2_every_tail_length():
    rng = np.random.default_rng(9)
    for n in range(0, 40):
        data = bytes(rng.integers(0, 256, n).astype(np.uint8))
        for seed in (0, 0x9747B28C, 0xFFFFFFFF):
            assert port_hashing.murmur2(data, seed) == jax_hashing.murmur2(data, seed)


def test_keyed_publish_routes_as_jax():
    js, ps = jax_rt.InMemoryStream(5), port_rt.InMemoryStream(5)
    for k in _keys()[:300]:
        assert ps.publish({"k": 1}, key=k) == js.publish({"k": 1}, key=k)
    assert [len(log) for log in ps._logs] == [len(log) for log in js._logs]


def _tail(P, d):
    os.makedirs(d)
    path = os.path.join(d, "j.log")
    tf = P.fs.TailFollower(path)
    steps = [tf.read()]
    with open(path, "w") as f:
        f.write("a\n\nb\npart")  # a torn tail
    steps.append(tf.read())
    steps.append(tf.torn_tail_offset())
    with open(path, "a") as f:
        f.write("ial\nc\n")
    steps.append(tf.read(max_lines=1, count_line=lambda s: bool(s.strip())))
    steps.append(tf.read())
    with open(path, "w") as f:
        f.write("z\n")  # rewritten shorter: truncation
    steps.append(tf.read())
    steps.append(tf.read())
    steps.append(tf.read(start_line=0))
    steps.append(tf.position)
    return {"steps": repr(steps)}


def test_tail_follower_matches_jax(tmp_path):
    assert_parity(run_both(_tail, tmp_path))


def test_config_dicts_match_jax():
    for C in (jax_config, port_config):
        assert C.StreamConfig().max_rows_per_segment == 1 << 20
    kw = {"stream_type": "file", "topic": "t", "decoder": "json", "properties": {"path": "/x"},
          "max_rows_per_segment": 99, "max_segment_seconds": 7}
    assert port_config.StreamConfig(**kw).to_dict() == jax_config.StreamConfig(**kw).to_dict()
    up = {"mode": "PARTIAL", "comparison_column": "ts", "partial_upsert_strategies": {"c": "INCREMENT"},
          "metadata_ttl": 5.0, "delete_record_column": "del"}
    assert port_config.UpsertConfig(**up).to_dict() == jax_config.UpsertConfig(**up).to_dict()
    assert port_config.DedupConfig().to_dict() == jax_config.DedupConfig().to_dict()
    d = jax_config.UpsertConfig(**up).to_dict()
    assert port_config.UpsertConfig.from_dict(d) == port_config.UpsertConfig(**up)
    assert port_config.StreamConfig.from_dict(jax_config.StreamConfig(**kw).to_dict()) == port_config.StreamConfig(**kw)
    assert port_config.DedupConfig.from_dict({"dedupEnabled": False}).enabled is False


def test_make_consumer_refusals_match_jax():
    for P in (pkg("jax"), pkg("port")):
        with pytest.raises(ValueError, match="memory stream requires"):
            P.stream.make_consumer(P.C.StreamConfig(stream_type="memory"), 0)
        with pytest.raises(ValueError, match="unknown stream type"):
            P.stream.make_consumer(P.C.StreamConfig(stream_type="kafka"), 0)
        with pytest.raises(ValueError, match="no streamConfigs"):
            P.R.RealtimeTableDataManager(events_schema(P), P.C.TableConfig("events"), "/nonexistent-never-made")


def test_superseded_snapshot_frees_device_columns(tmp_path):
    """A snapshot replaced by a newer one, or by a seal, drops its device
    cache (the plan cache may keep the segment object alive)."""
    P = pkg("port")
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(events_schema(P), events_config(P, max_rows=40), str(tmp_path), stream=stream)
    eng = attach(P, events_schema(P), events_config(P), mgr)
    stream.publish_many(event_rows(10), partition=0)
    mgr.consume_all()
    eng.query(EVENT_QUERIES["by_city"])
    first = mgr.managers[0].mutable.snapshot()
    assert first._device_cache  # the query staged its columns
    stream.publish_many(event_rows(5, seed=8), partition=0)
    mgr.consume_all()
    eng.query(EVENT_QUERIES["by_city"])
    second = mgr.managers[0].mutable.snapshot()
    assert second is not first and not first._device_cache and second._device_cache
    stream.publish_many(event_rows(30, seed=9), partition=0)  # seals at 40
    mgr.consume_all()
    assert len(mgr.sealed[0]) == 1 and not second._device_cache


# ---------------------------------------------------------------------------
# one data directory, two packages: each recovers what the other sealed
# ---------------------------------------------------------------------------
def _upsert_events_schema(P):
    S = P.S
    return S.Schema(
        name="events",
        fields=[
            S.FieldSpec("eid", S.DataType.LONG),
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("clicks", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
        ],
        primary_key_columns=["eid"],
    )


def _cross_config(P, upsert: bool):
    C = P.C
    return C.TableConfig(
        name="events",
        indexing=C.IndexingConfig(range_index_columns=["eid"], sorted_column="city"),
        segments=C.SegmentsConfig(time_column="ts"),
        stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=24),
        upsert=C.UpsertConfig(mode="FULL", comparison_column="ts") if upsert else None,
    )


def _cross_rows(n=130, seed=4):
    rng = np.random.default_rng(seed)
    return [{"eid": int(rng.integers(0, 40)), "city": ["nyc", "sf", "la"][int(rng.integers(0, 3))],
             "clicks": int(rng.integers(0, 100)), "ts": 1_000 + i} for i in range(n)]


CROSS_QUERIES = {
    "count_sum": "SELECT COUNT(*), SUM(clicks) FROM events",
    "by_city": "SELECT city, COUNT(*), SUM(clicks) FROM events GROUP BY city",
    "filtered": "SELECT city, COUNT(*), SUM(clicks) FROM events WHERE eid < 20 GROUP BY city",
}


def _answers(P, mgr, upsert):
    eng = attach(P, _upsert_events_schema(P), _cross_config(P, upsert), mgr)
    return {k: eng.query(sql).rows for k, sql in CROSS_QUERIES.items()}


@pytest.mark.parametrize("upsert", [False, True], ids=["append", "full_upsert"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_cross_package_recovery(tmp_path, writer, reader, upsert):
    """The writer's manager consumes over two partitions and seals; the
    reader's manager over the same data directory recovers the sealed
    segments (loaded with verify), bootstraps upsert, and re-consumes the
    same stream past the checkpoint: same rows, same answers."""
    W, R = pkg(writer), pkg(reader)
    rows = _cross_rows()
    d = str(tmp_path / "rt")
    streams = {}
    for P in (W, R):
        streams[P.name] = P.R.InMemoryStream(2)
        for r in rows:
            streams[P.name].publish(r, key=r["eid"])
    wm = W.R.RealtimeTableDataManager(_upsert_events_schema(W), _cross_config(W, upsert), d, stream=streams[writer])
    wm.consume_all()
    want = _answers(W, wm, upsert)
    with open(os.path.join(d, "checkpoint.json")) as f:
        cp = json.load(f)
    assert sorted(cp) == ["0", "1"] and all(set(v) == {"offset", "seq", "segments"} for v in cp.values())
    sealed = {p: [s.name for s in wm.sealed[p]] for p in (0, 1)}
    assert sum(len(v) for v in sealed.values()) >= 4
    rm = R.R.RealtimeTableDataManager(_upsert_events_schema(R), _cross_config(R, upsert), d, stream=streams[reader])
    assert {p: [s.name for s in rm.sealed[p]] for p in (0, 1)} == sealed
    for p in (0, 1):
        for a, b in zip(wm.sealed[p], rm.sealed[p]):
            for c in ("eid", "city", "clicks", "ts"):
                np.testing.assert_array_equal(np.asarray(b.column(c).decoded()), np.asarray(a.column(c).decoded()))
    rm.consume_all()
    assert rm.total_rows == wm.total_rows
    if upsert:  # the bootstrap and the re-consumed tail rebuilt the same masks
        for p in (0, 1):
            for a, b in zip(wm.sealed[p], rm.sealed[p]):
                np.testing.assert_array_equal(np.asarray(b.valid_docs), np.asarray(a.valid_docs))
    got = _answers(R, rm, upsert)
    for k in CROSS_QUERIES:
        assert_same_rows(got[k], want[k])
    if upsert:
        latest = {}
        for r in rows:
            latest[r["eid"]] = r
        want_rows = sqlite_rows(list(latest.values()), CROSS_QUERIES["by_city"])
    else:
        want_rows = sqlite_rows(rows, CROSS_QUERIES["by_city"])
    assert_sqlite_rows(got["by_city"], want_rows)
