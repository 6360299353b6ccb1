"""The port's segment deep store (cluster/deepstore.py) and the filesystem
contract under it (spi/filesystem.py PinotFS) against the JAX package's,
with what leans on them: a server's crash and restore, the realtime seal's
upload, rebalance's restore of a replica.

Every scenario runs in both packages (the helpers of
tests/test_torch_coordinator.py), each in its own directory, and what it
returns must agree; the port's query rows are held to a sqlite golden too.
Segment downloads are CRC-verified (segment/store.py verify_segment): a
corrupt local copy is quarantined aside and fetched again.

Mirrored: tests/test_crash_recovery.py's TestServerCrashRestart (restore
from the deep store, the breaker healed by restart, a corrupt local copy,
the scripted crash and restart mid-workload), TestSegmentCommitKillPoints
at all 12 seal kill-points with a deep store attached (the two
`deepstore.upload.*` among them), the checkpoint pointer the coordinator
journals, TestLiveRebalance's load-before-drop under queries, and
TestLifecycleChaosAcceptance.  Added: the PinotFS operations, URI schemes,
upload / put_segment / download edge cases and the download kill-point.
"""
import os

import pytest

from test_torch_coordinator import (  # noqa: F401  (fixtures)
    QUERIES, _jax_kill_points, assert_golden, assert_parity, build, data, golden_rows, make_cluster,
    port_state, quiet, run_both, schema, state,
)


def broker(P, coord):
    b = P.cl.Broker(coord)
    quiet(b)
    return b


def flip_byte(path, offset=0):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# PinotFS
# ---------------------------------------------------------------------------
def test_local_pinot_fs_operations(tmp_path):
    def scenario(P, d):
        fs = P.fs.LocalPinotFS()
        rel = lambda paths: sorted(os.path.relpath(p, d) for p in paths)  # noqa: E731
        fs.mkdir(str(d / "a" / "b"))
        (d / "a" / "b" / "f.txt").write_text("hello")
        (d / "a" / "g.txt").write_text("xy")
        out = {"exists": [fs.exists(str(d / "a" / "b" / "f.txt")), fs.exists(str(d / "nope"))],
               "length": fs.length(str(d / "a" / "b" / "f.txt")),
               "flat": rel(fs.list_files(str(d / "a"))), "deep": rel(fs.list_files(str(d / "a"), recursive=True))}
        fs.copy(str(d / "a"), str(d / "c" / "a"))
        fs.copy_to_local(str(d / "a" / "g.txt"), str(d / "local" / "g.txt"))
        fs.copy_from_local(str(d / "local" / "g.txt"), str(d / "remote" / "g.txt"))
        fs.move(str(d / "remote" / "g.txt"), str(d / "moved" / "g.txt"))
        out["after"] = rel(fs.list_files(str(d), recursive=True))
        out["delete"] = [fs.delete(str(d / "c")), fs.delete(str(d / "c"), force=True),
                         fs.delete(str(d / "moved" / "g.txt")), fs.delete(str(d / "nope"))]
        out["final"] = rel(fs.list_files(str(d), recursive=True))
        return out

    out = run_both(scenario, tmp_path)
    assert out["port"]["delete"] == [False, True, True, False]
    assert_parity(out)


def test_uri_schemes_and_registration():
    def scenario(P, _d):
        out = {"strip": [P.fs.strip_scheme(u) for u in ("file:///x/y", "/x/y", "s3://bucket/k")],
               "local": [type(P.fs.fs_for_uri(u)).__name__ for u in ("/x", "file:///x")]}
        with pytest.raises(ValueError, match="no PinotFS registered for scheme 's3'"):
            P.fs.fs_for_uri("s3://bucket/key")

        class MemFS(P.fs.PinotFS):
            pass

        P.fs.register_fs("mem", MemFS)
        try:
            out["mem"] = type(P.fs.fs_for_uri("mem://x")).__name__
            with pytest.raises(NotImplementedError):
                MemFS().exists("x")
        finally:
            P.fs._FS_REGISTRY.pop("mem")
        return out

    out = run_both(scenario)
    assert out["port"]["strip"] == ["/x/y", "/x/y", "/k"] and out["port"]["mem"] == "MemFS"
    assert_parity(out)


# ---------------------------------------------------------------------------
# upload and download
# ---------------------------------------------------------------------------
def test_upload_download_crc_and_quarantine(tmp_path):
    def scenario(P, d):
        ds = P.cl.SegmentDeepStore("file://" + str(d / "deep"))
        seg = build(P, data(300, seed=3), "seg0", out=d / "build" / "seg0")
        uri = ds.put_segment("t", seg)
        again = ds.upload("t", str(d / "build" / "seg0"))  # idempotent: first commit wins
        mem = build(P, data(100, seed=4), "seg_mem")  # built in memory: saved, then uploaded
        ds.put_segment("t", mem)
        out = {"uri": os.path.relpath(uri, d), "again": os.path.relpath(again, d), "list": ds.list_segments("t"),
               "has": [ds.has_segment("t", "seg0"), ds.has_segment("t", "nope")],
               "staging": sorted(p for p in os.listdir(d / "deep" / "t") if p.startswith("."))}
        local = str(d / "local")
        loaded = ds.fetch_segment("t", "seg0", local)
        out["decoded"] = loaded.column("v").decoded().tolist() == data(300, seed=3)["v"].tolist()
        flip_byte(os.path.join(local, "seg0", "columns.bin"))
        with pytest.raises(P.store.SegmentCorruptError):
            P.store.verify_segment(os.path.join(local, "seg0"))
        ds.download("t", "seg0", local)  # quarantined aside, fetched again
        P.store.verify_segment(os.path.join(local, "seg0"))
        out["quarantined"] = os.path.isdir(os.path.join(local, "seg0.corrupt"))
        with pytest.raises(FileNotFoundError):
            ds.download("t", "nope", local)
        P.crash.arm("deepstore.download.before_commit")
        with pytest.raises(P.cl.InjectedCrash):
            ds.download("t", "seg_mem", local)
        out["torn"] = [os.path.isdir(os.path.join(local, "seg_mem")),
                       os.path.isdir(os.path.join(local, "seg_mem.download"))]
        out["rows"] = ds.fetch_segment("t", "seg_mem", local).num_docs
        out["counters"] = {k: v for k, v in P.METRICS.snapshot()["counters"].items() if k.startswith("deepstore.")}
        return out

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["list"] == ["seg0", "seg_mem"] and p["decoded"] and p["quarantined"] and p["staging"] == []
    assert p["torn"] == [False, True] and p["rows"] == 100
    assert_parity(out)


# ---------------------------------------------------------------------------
# a server's crash and restore
# ---------------------------------------------------------------------------
def test_crash_then_restart_restores_from_deep_store(tmp_path):
    def scenario(P, d):
        coord, datas = make_cluster(P, d=d, durable=True)
        b = broker(P, coord)
        base = {sql: b.query(sql).rows for sql in QUERIES}
        victim = coord.servers["server0"]
        owned = sorted(victim.segment_names("t"))
        coord.crash_server("server0")
        crashed = (victim.crashed, dict(victim.segments))
        during = {sql: b.query(sql).rows for sql in QUERIES}
        stats = coord.restart_server("server0")
        restored = victim.get_segment("t", owned[0])
        return {"base": base, "during": during, "after": {sql: b.query(sql).rows for sql in QUERIES},
                "owned": owned, "crashed": crashed, "stats": stats, "back": sorted(victim.segment_names("t")),
                "live": "server0" in coord.live, "fromDisk": restored.source_dir is not None and
                os.path.realpath(restored.source_dir).startswith(os.path.realpath(d / "server0")),
                "datas": datas}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["owned"] and p["crashed"] == (True, {}) and p["back"] == p["owned"] and p["live"] and p["fromDisk"]
    assert p["stats"] == {"restored": len(p["owned"]), "dropped": 0, "missing": 0}
    gold = golden_rows(p.pop("datas"))
    for k in ("base", "during", "after"):
        assert_golden(p[k], gold)
    out["jax"].pop("datas")
    assert_parity(out)


def test_restart_heals_breaker_and_corrupt_local_copy(tmp_path):
    def scenario(P, d):
        coord, _ = make_cluster(P, n_servers=2, replication=2, d=d, durable=True)
        b = broker(P, coord)
        srv = coord.servers["server0"]
        seg_name = sorted(srv.segment_names("t"))[0]
        coord.crash_server("server0")
        b.query(QUERIES[0])  # routes around the dead server
        local = os.path.join(srv.data_dir, "t", seg_name)
        out = [os.path.isdir(local)]
        coord.restart_server("server0")
        res = b.query(QUERIES[0])
        out += [res.stats.partial_result, b.health.available("server0"), os.path.isdir(local)]
        flip_byte(os.path.join(local, "columns.bin"))
        coord.crash_server("server0")
        coord.restart_server("server0")
        P.store.verify_segment(local)  # fetched again, CRC-clean
        out += [os.path.isdir(local + ".corrupt"), srv.get_segment("t", seg_name) is not None,
                P.METRICS.counter("deepstore.corruptLocalCopies").value]
        return {"trail": out, "rows": b.query(QUERIES[0]).rows}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == [False, False, True, True, True, True, 1]
    assert_parity(out)


def test_scripted_crash_restart_mid_workload(tmp_path):
    def scenario(P, d):
        coord, datas = make_cluster(P, n_servers=2, replication=2, d=d, durable=True)
        plan = (P.cl.FaultPlan(seed=3).crash_server("server0", on_call=2, of="server1")
                .restart_server("server0", on_call=4, of="server1").attach(coord))
        b = broker(P, coord)
        rows = [{sql: b.query(sql).rows for sql in QUERIES} for _ in range(6)]
        return {"rows": rows, "log": [(s, n, k) for (s, n, k, _) in plan.log],
                "crashed": coord.servers["server0"].crashed, "datas": datas}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    kinds = [k for (_, _, k) in p["log"]]
    assert "crash" in kinds and "restart" in kinds and p["crashed"] is False
    gold = golden_rows(p.pop("datas"))
    for r in p["rows"]:
        assert_golden(r, gold)
    out["jax"].pop("datas")
    assert_parity(out)


# ---------------------------------------------------------------------------
# the realtime seal uploads through the deep store
# ---------------------------------------------------------------------------
SEAL_POINTS = [
    "segment.write.after_data_write",
    "segment.write.after_data_replace",
    "segment.write.meta.after_write",
    "segment.write.meta.after_replace",
    "segment.seal.after_build",
    "deepstore.upload.before_commit",
    "deepstore.upload.after_commit",
    "segment.seal.after_upload",
    "segment.seal.after_swap",
    "realtime.checkpoint.after_write",
    "realtime.checkpoint.after_bak",
    "realtime.checkpoint.after_replace",
]


@pytest.mark.parametrize("point", SEAL_POINTS)
def test_crash_at_every_seal_step_loses_nothing(point, tmp_path):
    """Kill the seal at each named step with a deep store attached: after
    the restart the table holds exactly the published rows, and every
    sealed segment the checkpoint names is in the deep store."""
    def scenario(P, d):
        cfg = P.C.TableConfig(name="t", stream=P.C.StreamConfig(stream_type="memory", max_rows_per_segment=16))
        stream = P.R.InMemoryStream(num_partitions=1)
        rows = data(50, seed=11)
        for i in range(50):
            stream.publish({k: rows[k][i] for k in rows}, partition=0)
        deep = P.cl.SegmentDeepStore(str(d / "deep"))
        mgr = P.R.RealtimeTableDataManager(schema(P), cfg, str(d / "rt"), stream=stream, deep_store=deep)
        P.crash.arm(point)
        with pytest.raises(P.cl.InjectedCrash):
            mgr.consume_all()
        fired = [f[0] for f in P.crash.fired]
        mgr2 = P.R.RealtimeTableDataManager(schema(P), cfg, str(d / "rt"), stream=stream, deep_store=deep)
        mgr2.consume_all()
        v = sum(int(s.column("v").decoded().sum()) for s in mgr2.query_segments())
        sealed = sorted(s.name for s in mgr2.query_segments() if not getattr(s, "in_memory", False))
        return {"fired": fired, "rows": mgr2.total_rows, "v": v, "deep": deep.list_segments("t"),
                "sealed": sealed, "want": int(rows["v"].sum())}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["fired"] == [point] and p["rows"] == 50 and p["v"] == p["want"]
    assert set(p["sealed"]) <= set(p["deep"])
    assert_parity(out)


def test_checkpoint_pointer_journaled_and_realtime_recovered(tmp_path):
    def scenario(P, d):
        cfg = P.C.TableConfig(name="rt", stream=P.C.StreamConfig(stream_type="memory", max_rows_per_segment=16))
        stream = P.R.InMemoryStream(num_partitions=2)
        for i in range(60):
            stream.publish({"city": "sf", "v": i, "ts": 1_700_000_000_000 + i}, key=f"k{i}")
        coord = P.cl.Coordinator(replication=1, meta_dir=str(d / "meta"), deep_store=str(d / "deep"))
        mgr = coord.add_realtime_table(schema(P, "rt"), cfg, str(d / "rt"), stream=stream)
        coord.run_realtime_consumption()
        committed = {p: dict(cp) for p, cp in coord.rt_checkpoints["rt"].items()}
        coord2 = P.cl.Coordinator(meta_dir=str(d / "meta"), deep_store=str(d / "deep"))
        mgr2 = coord2.recover_realtime("rt", stream=stream)
        coord2.run_realtime_consumption()
        return {"rows": [mgr.total_rows, mgr2.total_rows], "committed": committed,
                "restored": coord2.rt_checkpoints["rt"], "deep": coord.deep_store.list_segments("rt")}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["rows"] == [60, 60] and p["committed"] and p["restored"] == p["committed"] and p["deep"]
    assert_parity(out)


# ---------------------------------------------------------------------------
# rebalance restores through the deep store; the lifecycle acceptance
# ---------------------------------------------------------------------------
def test_rebalance_load_before_drop_under_queries(tmp_path):
    """A new server joins; rebalance moves segments onto it while queries
    run at every protocol step (the kill-points used as probes): the
    floor holds and every interleaved query is exact."""
    def scenario(P, d):
        coord, datas = make_cluster(P, n_servers=2, replication=2, n_segments=6, d=d, durable=True)
        gold = golden_rows(datas)
        b = broker(P, coord)
        coord.register_server(P.server("server_new", data_dir=str(d / "server_new")))
        floors, seen = [], []

        def probe(point):
            for sql in QUERIES:
                r = b.query(sql).rows
                if P.name == "port":
                    assert_golden({sql: r}, {sql: gold[sql]})
            floors.append(min(len(v) for v in coord.external_view("t").values()))
            seen.append(point)

        orig = P.rebalance.crash_point
        P.rebalance.crash_point = probe
        try:
            stats = coord.rebalance("t", min_available_replicas=1)
        finally:
            P.rebalance.crash_point = orig
        v, view = coord.versioned_view("t")
        return {"stats": stats, "floors": floors, "seen": seen, "moved": sorted(coord.servers[
            "server_new"].segment_names("t")), "rows": {sql: b.query(sql).rows for sql in QUERIES},
            "version": v, "view": {k: sorted(s) for k, s in view.items()}}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["stats"]["segmentsMoved"] > 0 and p["floors"] and min(p["floors"]) >= 1 and p["moved"]
    assert_parity(out)


def test_rebalance_restores_a_replica_from_the_deep_store(tmp_path):
    """No live peer holds the segment: the new replica is fetched from the
    deep store (CRC-verified) instead of shared."""
    def scenario(P, d):
        coord, datas = make_cluster(P, n_servers=1, replication=1, n_segments=2, d=d, durable=True)
        coord.register_server(P.server("server1", data_dir=str(d / "server1")))
        coord.replication = 2
        coord.crash_server("server0")  # the only copy's holder is gone
        report = coord.rebalance("t")
        srv = coord.servers["server1"]
        return {"report": report, "held": sorted(srv.segment_names("t")),
                "fromDeep": all(os.path.isdir(d / "server1" / "t" / n) for n in srv.segment_names("t")),
                "rows": broker(P, coord).query(QUERIES[0]).rows, "want": golden_rows(datas, QUERIES[:1])}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["held"] == ["seg0", "seg1"] and p["fromDeep"]
    assert_golden({QUERIES[0]: p["rows"]}, p.pop("want"))
    out["jax"].pop("want")
    assert_parity(out)


def test_lifecycle_chaos_end_to_end(tmp_path):
    """Seeded crashes and restarts mid-scatter, a rebalance between rounds,
    then the coordinator killed mid add_segment and restarted from its
    journal: every query is exact or a structured partial, the committed
    rows are served exactly once, and the floor holds."""
    def scenario(P, d):
        coord, datas = make_cluster(P, n_servers=3, replication=2, n_segments=5, d=d, durable=True)
        plan = (P.cl.FaultPlan(seed=42)
                .crash_server("server0", on_call=2, of="server1").restart_server("server0", on_call=5, of="server1")
                .crash_server("server2", on_call=7, of="server1").restart_server("server2", on_call=9, of="server1")
                .attach(coord))
        b = broker(P, coord)
        rounds, floors = [], []
        for _ in range(8):
            for sql in QUERIES:
                res = b.query("SET allowPartialResults = true; " + sql)
                rounds.append("partial" if res.stats.partial_result else res.rows)
            floors.append(min(len(v) for v in coord.external_view("t").values()))
        coord.rebalance("t")
        after = {sql: b.query(sql).rows for sql in QUERIES}
        pre = state(coord)
        P.crash.arm("coordinator.add_segment.after_journal")
        with pytest.raises(P.cl.InjectedCrash):
            coord.add_segment("t", build(P, data(80, seed=777), "seg_chaos", out=d / "build" / "seg_chaos"))
        coord2 = P.cl.Coordinator(meta_dir=str(d / "meta"), deep_store=str(d / "deep"))
        restored = state(coord2)
        chaos_meta = restored["tables"]["t"]["segmentMeta"].pop("seg_chaos")
        restored["tables"]["t"]["ideal"].pop("seg_chaos")
        for i in range(3):
            coord2.register_server(P.server(f"server{i}", data_dir=str(d / f"server{i}")))
        res = broker(P, coord2).query("SELECT COUNT(*), SUM(v) FROM t")
        return {"rounds": rounds, "floors": floors, "after": after, "same": restored == pre,
                "chaosDocs": chaos_meta["numDocs"], "count": res.rows[0][0], "partial": res.stats.partial_result,
                "kinds": [k for (_, _, k, _) in plan.log], "datas": datas}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    gold = golden_rows(p.pop("datas"))
    out["jax"].pop("datas")
    assert min(p["floors"]) >= 1 and p["same"] and p["chaosDocs"] == 80 and p["partial"] is False
    assert p["count"] == 5 * 200 + 80 and p["kinds"].count("crash") == 2 and p["kinds"].count("restart") == 2
    assert any(r != "partial" for r in p["rounds"])
    for i, r in enumerate(p["rounds"]):
        if r != "partial":
            assert_golden({QUERIES[i % len(QUERIES)]: r}, {QUERIES[i % len(QUERIES)]: gold[QUERIES[i % len(QUERIES)]]})
    assert_golden(p["after"], gold)
    assert_parity(out)
