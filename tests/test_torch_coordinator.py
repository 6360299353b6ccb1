"""The port's cluster/coordinator.py against the JAX package's.

Each scenario is written once over a package namespace (`pkg("jax")` or
`pkg("port")`: schema, config and builder modules, the cluster classes, a
server factory) and run in both packages on the same data, made from a
numpy seed; what it returns must agree.  Query rows are held with
`assert_rows_match` (tests/test_torch_query.py: exact cells and types; the
SUMs here are integer-valued) and, in the port, to a sqlite golden; ideal
states, external views and journaled control-plane states (`_state_dict`,
less each segment's creation time) must be equal.  The port's servers run
on the CPU (`ServerInstance(name, device="cpu")`).

Mirrored: tests/test_cluster.py (replicated assignment, replica groups,
rerouting around a down server, the replica-group selector, the
no-live-replica error, rebalance repairing under-replication and spreading
to a new server, retention, the coordinator-owned realtime table, liveness
and the periodic tasks, EXPLAIN through the broker).  Added: drop_table,
mesh_placement, versioned views, status reports, the periodic-task thread,
the journal's JSON forms of segment metadata, and the table config's dict
form.  The helpers here (`pkg`, `run_both`, `assert_parity`, `make_cluster`)
serve tests/test_torch_broker.py, test_torch_election.py and
test_torch_deepstore.py too.
"""
import copy
import threading
import types

import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import pinot_tpu.cluster as jax_cluster
from pinot_tpu import realtime as jax_rt
from pinot_tpu.cluster import broker as jax_broker_mod
from pinot_tpu.cluster import coordinator as jax_coord_mod
from pinot_tpu.cluster import election as jax_election
from pinot_tpu.cluster import journal as jax_journal
from pinot_tpu.cluster import rebalance as jax_rebalance
from pinot_tpu.segment import builder as jax_builder
from pinot_tpu.segment import store as jax_store
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import filesystem as jax_fs
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.sql.parser import parse_query as jax_parse
from pinot_tpu.utils import crashpoints as jax_crash
from pinot_tpu.utils import metrics as jax_metrics

import pinot_tpu_torch.cluster as port_cluster
from pinot_tpu_torch import realtime as port_rt
from pinot_tpu_torch.cluster import broker as port_broker_mod
from pinot_tpu_torch.cluster import coordinator as port_coord_mod
from pinot_tpu_torch.cluster import election as port_election
from pinot_tpu_torch.cluster import journal as port_journal
from pinot_tpu_torch.cluster import rebalance as port_rebalance
from pinot_tpu_torch.segment import builder as port_builder
from pinot_tpu_torch.segment import store as port_store
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import filesystem as port_fs
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import parse_query as port_parse
from pinot_tpu_torch.utils import crashpoints as port_crash
from pinot_tpu_torch.utils import metrics as port_metrics

from golden import assert_same_rows as assert_sqlite_rows
from golden import sqlite_from_data
from test_torch_query import assert_rows_match
from torch_port_state import port_state  # noqa: F401

PKGS = ("jax", "port")
T0 = 1_700_000_000_000
DAY = 86_400_000


def pkg(name: str) -> types.SimpleNamespace:
    """One package's cluster surface (modules, cluster classes, parser, and
    a server factory: the port's servers run on the CPU)."""
    if name == "jax":
        mods = dict(S=jax_schema, C=jax_config, B=jax_builder, cl=jax_cluster, R=jax_rt, store=jax_store,
                    fs=jax_fs, crash=jax_crash, metrics=jax_metrics, broker_mod=jax_broker_mod,
                    coord_mod=jax_coord_mod, election=jax_election, journal=jax_journal,
                    rebalance=jax_rebalance, parse=jax_parse)

        def server(n, **kw):
            return jax_cluster.ServerInstance(n, **kw)
    else:
        mods = dict(S=port_schema, C=port_config, B=port_builder, cl=port_cluster, R=port_rt, store=port_store,
                    fs=port_fs, crash=port_crash, metrics=port_metrics, broker_mod=port_broker_mod,
                    coord_mod=port_coord_mod, election=port_election, journal=port_journal,
                    rebalance=port_rebalance, parse=port_parse)

        def server(n, **kw):
            return port_cluster.ServerInstance(n, device="cpu", **kw)

    return types.SimpleNamespace(name=name, server=server, METRICS=mods["metrics"].METRICS, **mods)


@pytest.fixture(autouse=True)
def _jax_kill_points():
    """The JAX package's kill-points are process-global too (the port's
    reset with torch_port_state)."""
    jax_crash.reset()
    yield
    jax_crash.reset()


def run_both(scenario, tmp_path=None, *args):
    """scenario(P, dir, *args) in each package, each in its own directory."""
    return {name: scenario(pkg(name), None if tmp_path is None else tmp_path / name, *args) for name in PKGS}


def assert_same(got, want, path="out"):
    """Dicts key by key, lists of row tuples by assert_rows_match
    (ordered: cell values and types), everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list) and want and all(isinstance(r, tuple) for r in want):
        assert_rows_match(got, want, ordered=True)
    else:
        assert got == want, (path, got, want)


def assert_parity(out):
    """Both packages' results agree (assert_same)."""
    assert_same(out["port"], out["jax"])


# ---------------------------------------------------------------------------
# the table of tests/test_cluster.py
# ---------------------------------------------------------------------------
def schema(P, name="t"):
    S = P.S
    return S.Schema(
        name,
        [
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
        ],
    )


def config(P, name="t", **kw):
    return P.C.TableConfig(name=name, segments=P.C.SegmentsConfig(time_column="ts"), **kw)


def data(n, seed, t0=T0):
    rng = np.random.default_rng(seed)
    return {
        "city": rng.choice(["sf", "nyc", "la"], n).astype(object),
        "v": rng.integers(0, 100, n),
        "ts": t0 + rng.integers(0, DAY, n).astype(np.int64),
    }


def merged(datas):
    return {k: np.concatenate([d[k] for d in datas]) for k in datas[0]}


def build(P, d, name, cfg=None, out=None):
    return P.B.build_segment(schema(P), copy.deepcopy(d), name, table_config=cfg,
                             output_dir=None if out is None else str(out))


def make_cluster(P, n_servers=3, replication=2, n_segments=4, rows=200, seed0=100, d=None, durable=False,
                 **coord_kw):
    """Coordinator + servers + table "t" + segments seg{i} of data(rows,
    seed0 + i).  `durable` puts the journal under {d}/meta, the deep store
    under {d}/deep, each server's cache under {d}/server{i} and each
    segment's build under {d}/build.  Returns (coordinator, [data dicts])."""
    if durable:
        coord_kw.setdefault("meta_dir", str(d / "meta"))
        coord_kw.setdefault("deep_store", str(d / "deep"))
    coord = P.cl.Coordinator(replication=replication, **coord_kw)
    for i in range(n_servers):
        kw = {"data_dir": str(d / f"server{i}")} if durable else {}
        coord.register_server(P.server(f"server{i}", **kw))
    coord.add_table(schema(P), config(P))
    datas = []
    for i in range(n_segments):
        datas.append(data(rows, seed=seed0 + i))
        out = d / "build" / f"seg{i}" if durable else None
        coord.add_segment("t", build(P, datas[-1], f"seg{i}", out=out))
    return coord, datas


QUERIES = [
    "SELECT COUNT(*), SUM(v) FROM t",
    "SELECT city, COUNT(*), SUM(v) FROM t GROUP BY city ORDER BY city",
    "SELECT COUNT(*) FROM t WHERE v > 50 AND city = 'sf'",
]


def state(coord):
    """The journaled control-plane state, less creation times (each build
    stamps its own clock)."""
    st = coord._state_dict()
    for t in st["tables"].values():
        for sm in t["segmentMeta"].values():
            sm.pop("creationTimeMs", None)
    return st


def ideal(coord, table="t"):
    return {seg: sorted(s) for seg, s in coord.tables[table].ideal.items()}


def view(coord, table="t"):
    return {seg: sorted(s) for seg, s in coord.external_view(table).items()}


def quiet(broker):
    """Failover backoff recorded instead of slept; brownout verdicts off
    (they read wall-clock latencies, which would steer routing).  Returns
    the recorded backoffs."""
    slept = []
    broker._sleep = slept.append
    broker.health.brownout_min_samples = 1 << 30
    return slept


def golden_rows(datas, queries=QUERIES):
    conn = sqlite_from_data("t", merged(datas))
    return {sql: conn.execute(sql).fetchall() for sql in queries}


def query_rows(broker, queries=QUERIES):
    return {sql: broker.query(sql).rows for sql in queries}


def assert_golden(rows, gold):
    for sql, want in gold.items():
        assert_sqlite_rows(rows[sql], want)


# ---------------------------------------------------------------------------
# assignment, replica groups, routing
# ---------------------------------------------------------------------------
def test_replicated_assignment():
    def scenario(P, _d):
        coord, datas = make_cluster(P, n_servers=4, replication=2, n_segments=6, rows=250)
        rows = query_rows(P.cl.Broker(coord))
        return {"ideal": ideal(coord), "view": view(coord), "groups": dict(coord.replica_group),
                "state": state(coord), "version": coord.version, "rows": rows, "datas": datas}

    out = run_both(scenario)
    j, p = out["jax"], out["port"]
    assert all(len({j["groups"][s] for s in srvs}) == 2 for srvs in p["ideal"].values())
    for key in ("ideal", "view", "groups", "state", "version"):
        assert p[key] == j[key], key
    for sql in QUERIES:
        assert_rows_match(p["rows"][sql], j["rows"][sql], ordered=True)
    assert_golden(p["rows"], golden_rows(p["datas"]))


def test_mark_down_reroutes_and_mark_up_restores():
    def scenario(P, _d):
        coord, datas = make_cluster(P, n_servers=4, replication=2, n_segments=4, rows=200, seed0=10)
        broker = P.cl.Broker(coord)
        before = broker.query(QUERIES[1]).rows
        v0 = coord.version
        coord.mark_down("server0")  # replication 2: every segment still live
        down_view = view(coord)
        after = broker.query(QUERIES[1]).rows
        coord.mark_up("server0")
        return {"before": before, "after": after, "down_view": down_view, "bumps": coord.version - v0,
                "live": sorted(coord.live), "view": view(coord), "datas": datas}

    out = run_both(scenario)
    p = out["port"]
    assert all("server0" not in srvs for srvs in p["down_view"].values()) and p["bumps"] == 2
    gold = golden_rows(p["datas"], [QUERIES[1]])
    assert_golden({QUERIES[1]: p["after"]}, gold)
    del out["jax"]["datas"], p["datas"]
    assert_parity(out)


def test_replica_group_selector_serves_from_one_group():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=4, replication=2, n_segments=4, rows=150, seed0=20)
        broker = P.cl.Broker(coord, selector="replicagroup")
        res = broker.query("SELECT COUNT(*) FROM t")
        routes = [broker._route("t", [f"seg{i}" for i in range(4)]) for _ in range(3)]
        groups = [sorted({coord.replica_group[s] for s in r}) for r in routes]
        return {"rows": res.rows, "routes": routes, "groups": groups}

    out = run_both(scenario)
    assert out["port"]["rows"] == [(600,)]
    assert all(len(g) == 1 for g in out["port"]["groups"])
    assert_parity(out)


def test_no_live_replica_raises():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=1, rows=100, seed0=1)
        for s in sorted(coord.live):
            coord.mark_down(s)
        with pytest.raises(P.cl.NoReplicaAvailableError, match="no live replica") as ei:
            P.cl.Broker(coord).query("SELECT COUNT(*) FROM t")
        return {"msg": str(ei.value)}

    assert_parity(run_both(scenario))


def test_assign_tops_up_from_other_groups_when_a_group_is_dead():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=4, replication=2, n_segments=2, rows=50)
        coord.mark_down("server1")
        coord.mark_down("server3")  # group 1 has no live member
        targets = coord.add_segment("t", build(P, data(50, seed=7), "seg_late"))
        return {"targets": sorted(targets), "ideal": ideal(coord)}

    out = run_both(scenario)
    assert len(out["port"]["targets"]) == 2
    assert_parity(out)


# ---------------------------------------------------------------------------
# rebalance
# ---------------------------------------------------------------------------
def test_rebalance_repairs_under_replication():
    def scenario(P, _d):
        coord, datas = make_cluster(P, n_servers=3, replication=2, n_segments=6, rows=200, seed0=30)
        coord.mark_down("server1")
        under = sorted(coord.status_report()["t"]["underReplicated"])
        report = coord.rebalance("t")
        rows = query_rows(P.cl.Broker(coord))
        holders = {s: sorted(srv.segment_names("t")) for s, srv in coord.servers.items()}
        return {"under": under, "report": report, "view": view(coord), "ideal": ideal(coord),
                "state": state(coord), "rows": rows, "holders": holders, "datas": datas}

    out = run_both(scenario)
    p = out["port"]
    assert p["under"] and p["report"]["replicasAdded"] > 0
    assert all(len(s) >= 2 for s in p["view"].values())
    assert_golden(p["rows"], golden_rows(p["datas"]))
    for k in ("under", "report", "view", "ideal", "state", "holders"):
        assert p[k] == out["jax"][k], k


def test_rebalance_spreads_to_new_server_sharing_segment_objects():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=8, rows=100, seed0=40)
        objs = {n: coord._find_segment_object("t", n, coord.live) for n in coord.tables["t"].ideal}
        s_new = P.server("server_new")
        coord.register_server(s_new)
        report = coord.rebalance("t")
        moved = sorted(s_new.segment_names("t"))
        # a moved replica is the peer's segment object, not a reload
        shared = all(s_new.get_segment("t", n) is objs[n] for n in moved)
        return {"report": report, "moved": moved, "shared": shared, "ideal": ideal(coord),
                "count": P.cl.Broker(coord).query("SELECT COUNT(*) FROM t").rows}

    out = run_both(scenario)
    assert out["port"]["moved"] and out["port"]["shared"] and out["port"]["count"] == [(800,)]
    assert_parity(out)


# ---------------------------------------------------------------------------
# retention, drop, periodic tasks, liveness
# ---------------------------------------------------------------------------
def test_retention_purges_old_segments():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=0)
        cfg = coord.tables["t"].config
        cfg.segments.retention_time_value = 7
        cfg.segments.retention_time_unit = "DAYS"
        now = T0 + 30 * DAY
        coord.add_segment("t", build(P, data(100, seed=1, t0=now - DAY), "fresh", cfg=cfg))
        coord.add_segment("t", build(P, data(100, seed=2, t0=now - 20 * DAY), "stale", cfg=cfg))
        purged = coord.run_retention(now_ms=now)
        held = sorted(n for srv in coord.servers.values() for n in srv.segment_names("t"))
        return {"purged": purged, "held": held, "state": state(coord),
                "count": P.cl.Broker(coord).query("SELECT COUNT(*) FROM t").rows}

    out = run_both(scenario)
    assert out["port"]["purged"] == ["t/stale"] and out["port"]["count"] == [(100,)]
    assert_parity(out)


def test_drop_table_releases_every_replica():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=3, replication=2, n_segments=3, rows=60)
        coord.drop_table("t")
        left = {s: srv.segment_names("t") for s, srv in coord.servers.items()}
        gauges = {k: v for k, v in P.METRICS.snapshot()["gauges"].items() if k.startswith("server.segmentBytes")}
        return {"tables": sorted(coord.tables), "left": left, "gauges": gauges, "state": state(coord)}

    out = run_both(scenario)
    assert out["port"]["tables"] == [] and all(v == [] for v in out["port"]["left"].values())
    assert all(v == 0 for v in out["port"]["gauges"].values())
    assert_parity(out)


def test_liveness_and_auto_rebalance():
    import time as _time

    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=3, replication=2, n_segments=4, rows=200, seed0=70)
        for s in coord.servers:
            coord.heartbeat(s)
        coord._heartbeats["server2"] = _time.monotonic() - 120  # stale
        report = coord.run_periodic_tasks(heartbeat_timeout_s=30)
        dropped = report["serversDropped"]
        # a heartbeat from the dropped server brings it back
        coord.heartbeat("server2")
        return {"report": report, "dropped": dropped, "view": view(coord), "live": sorted(coord.live),
                "count": P.cl.Broker(coord).query("SELECT COUNT(*) FROM t").rows}

    out = run_both(scenario)
    p = out["port"]
    assert p["dropped"] == ["server2"] and p["report"]["tablesRebalanced"] == ["t"]
    assert all(len(s) >= 2 for s in p["view"].values()) and p["count"] == [(800,)]
    assert p["live"] == ["server0", "server1", "server2"]
    assert_parity(out)


def test_periodic_task_thread_ticks_and_stops():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=1, rows=20)
        stop, ticked = threading.Event(), threading.Event()
        reports = []
        tick = coord.run_periodic_tasks

        def one_tick(**kw):
            reports.append(tick(**kw))
            stop.set()
            ticked.set()
            return reports[-1]

        coord.run_periodic_tasks = one_tick
        t = coord.start_periodic_tasks(interval_s=0.0, stop_event=stop)
        assert ticked.wait(30)
        t.join(30)
        return {"alive": t.is_alive(), "daemon": t.daemon, "reports": reports}

    out = run_both(scenario)
    assert out["port"]["alive"] is False and len(out["port"]["reports"]) == 1
    assert_parity(out)


def test_views_placement_and_status_report():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=4, replication=2, n_segments=4, rows=50)
        v0, vw = coord.versioned_view("t")
        coord.mark_down("server3")
        v1, _ = coord.versioned_view("t")
        rep = coord.status_report()["t"]
        return {"v0": v0, "v1": v1, "view": {k: sorted(s) for k, s in vw.items()},
                "mesh2": coord.mesh_placement(2), "mesh3": coord.mesh_placement(3),
                "under": sorted(rep["underReplicated"]), "segments": rep["segments"],
                "liveServers": rep["liveServers"], "reserved": sorted(rep["reservedBytes"]),
                "residency": sorted(rep["residency"]), "election": coord.election_snapshot()["leader"]}

    out = run_both(scenario)
    assert out["port"]["v1"] == out["port"]["v0"] + 1
    assert_parity(out)


# ---------------------------------------------------------------------------
# the coordinator-owned realtime table
# ---------------------------------------------------------------------------
def test_coordinator_owned_realtime_table(tmp_path):
    def scenario(P, d):
        coord = P.cl.Coordinator(replication=1)
        coord.register_server(P.server("s0"))
        stream = P.R.InMemoryStream(1)
        cfg = P.C.TableConfig(name="rt", segments=P.C.SegmentsConfig(time_column="ts"),
                              stream=P.C.StreamConfig(stream_type="memory", max_rows_per_segment=40))
        mgr = coord.add_realtime_table(schema(P, "rt"), cfg, str(d / "rt"), stream=stream)
        stream.publish_many([{"city": ["sf", "nyc"][i % 2], "v": i, "ts": T0 + i} for i in range(100)],
                            partition=0)
        consumed = coord.run_realtime_consumption()
        res = P.cl.Broker(coord).query("SELECT city, COUNT(*), SUM(v) FROM rt GROUP BY city ORDER BY city")
        return {"consumed": consumed, "rows": res.rows, "sealed": len(mgr.query_segments()),
                "checkpoints": coord.rt_checkpoints, "realtime": sorted(coord.realtime)}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["consumed"] == 100
    assert p["rows"] == [("nyc", 50, float(sum(range(1, 100, 2)))), ("sf", 50, float(sum(range(0, 100, 2))))]
    assert p["checkpoints"]["rt"]
    assert_parity(out)


def test_explain_via_broker():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=1, rows=200, seed0=99)
        res = P.cl.Broker(coord).query(
            "EXPLAIN PLAN FOR SELECT city, SUM(v) FROM t WHERE city = 'sf' GROUP BY city")
        return {"columns": res.columns, "ops": [r[0].split("(")[0] for r in res.rows]}

    out = run_both(scenario)
    assert out["port"]["columns"] == ["Operator", "Operator_Id", "Parent_Id"]
    assert "GROUP_BY" in out["port"]["ops"]
    assert_parity(out)


# ---------------------------------------------------------------------------
# journal forms
# ---------------------------------------------------------------------------
def test_segment_meta_json_forms():
    import json

    value = {"a": np.int64(3), "b": (1, 2), "c": {3, 1}, "d": b"\x00\xff", "e": [np.float32(0.5)]}
    want = jax_coord_mod._jsonable(value)
    got = port_coord_mod._jsonable(value)
    assert got == want and json.dumps(got) == json.dumps(want)
    assert port_coord_mod._unjsonable(got) == jax_coord_mod._unjsonable(want)
    # torch scalars unwrap at the journal boundary too
    assert port_coord_mod._jsonable({"n": torch.tensor(7)}) == {"n": 7}
    sm = {"timeRange": [1, 2], "partition": ["city", 0, 3], "numDocs": 5}
    assert port_coord_mod._restore_seg_meta(sm) == jax_coord_mod._restore_seg_meta(sm)


def test_table_config_dict_forms_match():
    def scenario(P, _d):
        C = P.C
        cfg = C.TableConfig(
            name="x", table_type=C.TableType.REALTIME,
            indexing=C.IndexingConfig(inverted_index_columns=["city"], range_index_columns=["v"]),
            segments=C.SegmentsConfig(time_column="ts", retention_time_value=7, replication=2),
            stream=C.StreamConfig(stream_type="memory", topic="x"),
            partition_column="city", num_partitions=4, max_queries_per_second=2.5,
        )
        d = cfg.to_dict()
        back = C.TableConfig.from_json(cfg.to_json())
        return {"dict": d, "roundtrip": back.to_dict() == d, "withType": cfg.table_name_with_type}

    out = run_both(scenario)
    assert out["port"]["roundtrip"]
    assert_parity(out)
