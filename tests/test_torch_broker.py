"""The port's cluster/broker.py against the JAX package's.

Every scenario runs in both packages over the same data and call sequence
(the helpers of tests/test_torch_coordinator.py) and what it returns must
agree: query rows by `assert_rows_match`, routing tables, fault logs,
breaker states, counters and errors exactly; the port's rows are also held
to a sqlite golden, and the set ops, IN (SELECT ...) and EXPLAIN routes to
the port's own segment engine (`QueryEngine(device="cpu")`).

No assertion reads a wall clock.  Failures come from FaultPlan's scripted
rules; the failover backoff is the broker's injectable `_sleep` (recorded,
never slept); breaker and quota clocks are injected; the micro-batcher runs
on `batch_clock` and flushes on `drain_batches`.  A hedge is forced, not
raced: the primary's fault-plan sleep blocks on an event that opens only
after the backup has answered, so the hedge fires, the backup wins and the
loser is cancelled on every run; the decisions are read from the counters
and `HedgeController.snapshot()`.

Mirrored: tests/test_cluster.py's pruners and hybrid table,
tests/test_broker_quota.py's quota and adaptive selection,
tests/test_fault_tolerance.py (failover, dropped segments, seeded chaos,
exhaustion, partial results, the breaker), tests/test_tail_tolerance.py
(hedge delay, hedged and batched-hedged scatter, budget, admission,
brownout routing), tests/test_batching.py (submit / query_many /
drain_batches, member stats, bypasses) and the broker's metric federation.
"""
import threading

import numpy as np
import pytest

import pinot_tpu.utils.metrics as jax_metrics
from pinot_tpu.query import planner as jax_planner

from pinot_tpu_torch.query import executor as port_executor
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
import pinot_tpu_torch.utils.metrics as port_metrics

from test_torch_coordinator import (  # noqa: F401  (fixtures)
    QUERIES, T0, DAY, _jax_kill_points, assert_golden, assert_parity, assert_same, build, config, data,
    golden_rows, make_cluster, pkg, port_state, quiet, run_both, schema,
)
from test_torch_query import assert_rows_match

SQL = "SELECT city, COUNT(*), SUM(v) FROM t GROUP BY city ORDER BY city"


def hedged(sql, delay_ms=5, budget_pct=100):
    return f"SET hedge = true; SET hedgeDelayMs = {delay_ms}; SET hedgeBudgetPct = {budget_pct}; " + sql


def counters(P, *names):
    snap = P.METRICS.snapshot()["counters"]
    return {n: snap.get(n, 0) for n in names}


# ---------------------------------------------------------------------------
# routing and pruning
# ---------------------------------------------------------------------------
def test_route_selectors():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=4, replication=2, n_segments=6, rows=30)
        segs = [f"seg{i}" for i in range(6)]
        out = {}
        for sel in ("balanced", "replicagroup", "adaptive"):
            b = P.cl.Broker(coord, selector=sel)
            for s, ms in (("server0", 9.0), ("server1", 1.0), ("server2", 4.0), ("server3", 2.0)):
                b.server_stats.begin(s)
                b.server_stats.end(s, ms)
            out[sel] = [b._route("t", segs) for _ in range(3)]
            out[sel + "_excl"] = b._route("t", segs, exclude=frozenset({"server1"}))
            out[sel + "_pref"] = b._route("t", segs, prefer_group=1)
        b = P.cl.Broker(coord)
        coord.mark_down("server0")
        coord.mark_down("server2")
        out["partial"] = b._route("t", segs, exclude=frozenset({"server1", "server3"}), partial_ok=True)
        return out

    out = run_both(scenario)
    assert out["port"]["partial"] == ({}, [f"seg{i}" for i in range(6)])
    assert_parity(out)


def test_time_and_partition_pruners():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=0)
        for i in range(4):
            coord.add_segment("t", build(P, data(100, seed=50 + i, t0=T0 + i * 10 * DAY), f"seg{i}"))
        b = P.cl.Broker(coord)
        res = b.query(f"SELECT COUNT(*), SUM(v) FROM t WHERE ts >= {T0 + 30 * DAY}")
        res2 = b.query(f"SELECT COUNT(*) FROM t WHERE ts BETWEEN {T0 + 5 * DAY} AND {T0 + 12 * DAY}")
        cfg = config(P, "p", partition_column="city", num_partitions=3)
        coord.add_table(schema(P, "p"), cfg)
        for i, city in enumerate(["sf", "nyc", "la"]):
            d = data(200, seed=60 + i)
            d["city"] = np.array([city] * 200, dtype=object)
            coord.add_segment("p", P.B.build_segment(schema(P, "p"), d, f"p_{city}", table_config=cfg))
        res3 = b.query("SELECT COUNT(*) FROM p WHERE city = 'nyc'")
        res4 = b.query("SELECT COUNT(*) FROM p WHERE city IN ('nyc', 'la')")
        ctx = P.parse("SELECT COUNT(*) FROM p WHERE city = 'sf'")
        return {"rows": [res.rows, res2.rows, res3.rows, res4.rows],
                "pruned": [r.stats.num_segments_pruned for r in (res, res2, res3, res4)],
                "prune": b._prune(ctx, "p")}

    out = run_both(scenario)
    p = out["port"]
    assert p["pruned"][0] == 3 and p["rows"][0][0][0] == 100
    assert p["rows"][2] == [(200,)] and p["pruned"][2] == 2 and p["pruned"][3] == 1
    assert p["prune"] == (["p_sf"], 2)
    assert_parity(out)


# ---------------------------------------------------------------------------
# quota
# ---------------------------------------------------------------------------
def test_quota_token_bucket():
    def scenario(P, _d):
        q = P.broker_mod.QueryQuotaManager()
        out = []
        for qps, now in [(3.0, 100.0), (3.0, 100.001), (3.0, 100.002), (3.0, 100.01), (3.0, 100.5),
                         (0.5, 200.0), (0.5, 201.0), (0.5, 202.1), (0.0, 300.0), (0.0, 300.0)]:
            try:
                q.check(f"t{qps}", qps, now=now)
                out.append(True)
            except P.broker_mod.QuotaExceededError:
                out.append(False)
        return {"admitted": out}

    out = run_both(scenario)
    assert out["port"]["admitted"] == [True, True, True, False, True, True, False, True, True, True]
    assert_parity(out)


def test_broker_enforces_quota_once_per_request():
    def scenario(P, _d):
        coord = P.cl.Coordinator(replication=1)
        coord.register_server(P.server("s0"))
        cfg = config(P, max_queries_per_second=2.0)
        coord.add_table(schema(P), cfg)
        coord.add_segment("t", build(P, data(100, seed=0), "s", cfg=cfg))
        b = P.cl.Broker(coord)
        b.quota.clock = lambda: 1000.0  # frozen: query time never refills
        out = [b.query("SELECT COUNT(*) FROM t").rows, b.query("SELECT COUNT(*) FROM t").rows]
        with pytest.raises(P.broker_mod.QuotaExceededError) as ei:
            b.query("SELECT COUNT(*) FROM t")
        b.quota.clock = lambda: 1000.6
        # one request, one token: the UNION's second operand rides it
        out.append(b.query("SELECT COUNT(*) FROM t UNION ALL SELECT COUNT(*) FROM t").rows)
        return {"rows": out, "err": str(ei.value)}

    out = run_both(scenario)
    assert out["port"]["rows"][2] == [(100,), (100,)]
    assert_parity(out)


# ---------------------------------------------------------------------------
# failover, partial results, the breaker
# ---------------------------------------------------------------------------
def test_server_killed_mid_scatter_fails_over_exactly():
    def scenario(P, _d):
        coord, datas = make_cluster(P, n_servers=2, replication=2, n_segments=4, rows=300)
        plan = P.cl.FaultPlan(seed=7).fail_server("server0", on_call=1).attach(coord)
        b = P.cl.Broker(coord)
        slept = quiet(b)
        rows, stats = {}, []
        for sql in QUERIES:
            res = b.query(sql)
            rows[sql] = res.rows
            stats.append((res.stats.partial_result, res.stats.num_servers_queried,
                          res.stats.num_servers_responded, [e["errorCode"] for e in res.stats.exceptions]))
        return {"rows": rows, "stats": stats, "log": plan.log, "slept": slept, "datas": datas,
                "counters": counters(P, "broker.scatterServerFailures")}

    out = run_both(scenario)
    p = out["port"]
    assert_golden(p["rows"], golden_rows(p.pop("datas")))
    out["jax"].pop("datas")
    assert any(e[2] == "fail" for e in p["log"]) and all(s[0] is False for s in p["stats"])
    assert p["slept"] and p["counters"]["broker.scatterServerFailures"] == 1
    assert_parity(out)


def test_dropped_segment_fails_over():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=3, replication=2, n_segments=4, rows=300)
        plan = P.cl.FaultPlan(seed=3).drop_segment("server0", "t", "seg0").attach(coord)
        b = P.cl.Broker(coord)
        quiet(b)
        return {"rows": [b.query(QUERIES[0]).rows for _ in range(4)], "log": plan.log}

    out = run_both(scenario)
    assert len({tuple(r) for r in out["port"]["rows"]}) == 1
    assert_parity(out)


def test_seeded_chaos_is_the_same_in_both_packages():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=4, replication=2, n_segments=6, rows=300)
        plan = P.cl.FaultPlan(seed=1234).chaos([f"server{i}" for i in range(4)], p_fail=0.4).attach(coord)
        b = P.cl.Broker(coord)
        slept = quiet(b)
        res = b.query("SET allowPartialResults = true; " + SQL)
        return {"rows": res.rows, "partial": res.stats.partial_result, "log": plan.log,
                "exceptions": [(e["errorCode"], e.get("server")) for e in res.stats.exceptions],
                "slept": slept}

    assert_parity(run_both(scenario))


def test_exhaustion_raises_no_replica_available():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=2, rows=100)
        P.cl.FaultPlan(seed=1).always_fail("server0").always_fail("server1").attach(coord)
        b = P.cl.Broker(coord)
        quiet(b)
        with pytest.raises(P.cl.NoReplicaAvailableError, match="no live replica") as ei:
            b.query(QUERIES[0])
        return {"msg": str(ei.value)}

    assert_parity(run_both(scenario))


def test_partial_results_metadata():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=4, rows=300)
        P.cl.FaultPlan(seed=11).always_fail("server0", message="injected crash").attach(coord)
        b = P.cl.Broker(coord)
        quiet(b)
        res = b.query("SET allowPartialResults = true; SELECT COUNT(*) FROM t")
        live_docs = sum(s.num_docs for s in coord.servers["server1"].segments["t"].values())
        with pytest.raises(P.cl.NoReplicaAvailableError):
            b.query("SELECT COUNT(*) FROM t")
        st = res.stats
        return {"rows": res.rows, "live": live_docs, "response": {
            "partialResult": st.partial_result, "numServersQueried": st.num_servers_queried,
            "numServersResponded": st.num_servers_responded, "exceptions": st.exceptions,
            "docs": (st.num_segments_queried, st.num_segments_processed, st.num_docs_scanned, st.total_docs)}}

    out = run_both(scenario)
    p = out["port"]
    assert p["response"]["partialResult"] is True and p["rows"] == [(p["live"],)] and p["live"] > 0
    assert p["response"]["numServersResponded"] < p["response"]["numServersQueried"]
    assert_parity(out)


def test_breaker_quarantine_then_half_open_probe():
    def scenario(P, _d):
        clk = [0.0]
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=4, rows=300)
        plan = P.cl.FaultPlan(seed=2).fail_server("server0", on_call=1, times=3).attach(coord)
        b = P.cl.Broker(coord)
        quiet(b)
        b.health.clock = lambda: clk[0]
        b.health.cooldown_s = 30.0
        states, rows = [], []
        for _ in range(3):
            rows.append(b.query(QUERIES[0]).rows)
        states.append(b.health.state("server0"))
        opened = plan.calls("server0")
        for _ in range(3):
            rows.append(b.query(QUERIES[0]).rows)
        assign, _ = b._route("t", [f"seg{i}" for i in range(4)], partial_ok=True)
        quarantined_calls = plan.calls("server0")
        clk[0] += 31.0
        states.append(b.health.state("server0"))
        for _ in range(4):
            rows.append(b.query(QUERIES[0]).rows)
        states.append(b.health.state("server0"))
        return {"rows": rows, "states": states, "opened": opened, "quarantined": quarantined_calls,
                "after": plan.calls("server0"), "assign": assign,
                "failures": b.health.consecutive_failures("server0")}

    out = run_both(scenario)
    p = out["port"]
    assert p["states"] == ["open", "half_open", "closed"] and p["opened"] == p["quarantined"] < p["after"]
    assert "server0" not in p["assign"] and len({tuple(r) for r in p["rows"]}) == 1
    assert_parity(out)


def test_server_health_breaker_and_brownout_units():
    def scenario(P, _d):
        now = [0.0]
        h = P.cl.ServerHealth(failure_threshold=2, cooldown_s=10.0)
        h.clock = lambda: now[0]
        trail = []
        h.record_failure("s")
        h.record_failure("s")
        trail.append((h.state("s"), h.available("s")))
        now[0] = 11.0
        trail.append((h.state("s"), h.available("s")))
        h.begin_probe("s")
        trail.append(h.available("s"))
        h.record_failure("s")
        trail.append((h.state("s"), h.available("s")))
        now[0] = 22.0
        h.begin_probe("s")
        h.record_success("s")
        trail.append((h.state("s"), h.available("s")))
        for _ in range(8):
            h.note_latency("fast", 1.0)
        trail.append([h.note_latency("slow", 30.0) for _ in range(8)])
        trail.append((h.state("slow"), h.in_brownout("slow"), h.brownout_deprioritized("slow")))
        now[0] = 22.0 + h.brownout_cooldown_s + 1
        for _ in range(12):
            h.note_latency("slow", 1.0)
        trail.append((h.in_brownout("slow"), h.state("slow")))
        return {"trail": trail}

    out = run_both(scenario)
    assert out["port"]["trail"][5][-1] == "enter"
    assert_parity(out)


def test_router_weights_away_browned_replica():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=4, rows=30)
        b = P.cl.Broker(coord)
        for _ in range(8):
            b.health.note_latency("server1", 1.0)
            b.health.note_latency("server0", 30.0)
        return {"assign": b._route("t", [f"seg{i}" for i in range(4)])}

    out = run_both(scenario)
    assert set(out["port"]["assign"]) == {"server1"}
    assert_parity(out)


def test_failover_backoff_is_seeded_jitter():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=3, replication=3, n_segments=2, rows=50)
        P.cl.FaultPlan(seed=5).fail_server("server0", on_call=1, times=5).fail_server(
            "server1", on_call=1, times=5).attach(coord)
        b = P.cl.Broker(coord)
        slept = quiet(b)
        res = b.query("SET scatterBackoffMs = 8; SELECT COUNT(*) FROM t")
        return {"rows": res.rows, "slept": slept}

    out = run_both(scenario)
    assert out["port"]["rows"] == [(100,)] and out["port"]["slept"]
    assert_parity(out)


def test_mark_up_resets_breaker():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=2, rows=30)
        b = P.cl.Broker(coord)
        for _ in range(3):
            b.health.record_failure("server0")
        before = b.health.state("server0")
        coord.mark_down("server0")
        coord.mark_up("server0")
        return {"before": before, "after": b.health.state("server0")}

    out = run_both(scenario)
    assert out["port"] == {"before": "open", "after": "closed"}
    assert_parity(out)


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------
def test_hedge_delay_derivation_and_budget():
    def scenario(P, _d):
        hc = P.cl.HedgeController()
        hc.env_delay_ms = None
        hc.min_samples = 8
        cold = []
        for i in range(10):
            hc.observe("t", "slow", 500.0)
            hc.observe("t", "fast", float(i + 1))
            cold.append(hc.delay_ms("t", "other"))
        out = {"slow": hc.delay_ms("t", "slow"), "fast": hc.delay_ms("t", "fast"), "cold": cold}
        hc.env_delay_ms = 7.5
        out["env"] = hc.delay_ms("t", "p")
        out["opt"] = hc.delay_ms("t", "p", {"hedgeDelayMs": 3})
        hc.budget_pct = 50.0
        for _ in range(4):
            hc.note_primary()
        fires = [hc.try_fire(), hc.try_fire(), hc.try_fire()]
        hc.unfire()
        fires.append(hc.try_fire())
        out["fires"] = fires
        out["snapshot"] = hc.snapshot()
        return out

    out = run_both(scenario)
    assert out["port"]["fires"] == [True, True, False, True]
    assert_parity(out)


def _gated(plan):
    """The first fault-plan sleep (the primary's) blocks until `gate` opens;
    later ones (the backup's) return at once."""
    gate, lock, first = threading.Event(), threading.Lock(), [True]

    def sleep(_s):
        with lock:
            me, first[0] = first[0], False
        if me:
            gate.wait(60)

    plan.sleep = sleep
    return gate


def test_hedged_scatter_backup_wins_and_loser_is_cancelled():
    def scenario(P, _d):
        coord, datas = make_cluster(P, n_servers=2, replication=2, n_segments=1, rows=300)
        plan = P.cl.FaultPlan(seed=7).jitter("server0", base_ms=1.0, sigma=0.0).jitter(
            "server1", base_ms=1.0, sigma=0.0).attach(coord)
        gate = _gated(plan)
        b = P.cl.Broker(coord)
        quiet(b)
        res = b.query(hedged(SQL))
        gate.set()
        alive = b.hedge_drain(timeout_s=60)
        c = counters(P, "broker.hedgesLaunched", "broker.hedgeWins", "broker.hedgesCancelled",
                     "broker.hedgesDenied", "broker.scatterServerFailures", "broker.serversQuarantined")
        return {"rows": res.rows, "hedged": res.stats.hedged, "winner": res.stats.hedge_winner,
                "alive": alive, "counters": c, "hedge": b.hedge.snapshot(),
                "states": [b.health.state(s) for s in ("server0", "server1")],
                "slowlog": {k: v for k, v in b.slow_queries.snapshot()[0]["hedge"].items() if k != "cancelledMs"},
                "datas": datas}

    out = run_both(scenario)
    p = out["port"]
    assert_golden({SQL: p["rows"]}, golden_rows(p.pop("datas"), [SQL]))
    out["jax"].pop("datas")
    assert p["hedged"] == 1 and p["alive"] == 0 and p["states"] == ["closed", "closed"]
    assert p["counters"] == {"broker.hedgesLaunched": 1, "broker.hedgeWins": 1, "broker.hedgesCancelled": 1,
                             "broker.hedgesDenied": 0, "broker.scatterServerFailures": 0,
                             "broker.serversQuarantined": 0}
    assert_parity(out)


def test_hedge_denied_by_budget_and_inline_without_spare_replica():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=1, rows=100)
        plan = P.cl.FaultPlan(seed=7).jitter("server0", base_ms=1.0, sigma=0.0).jitter(
            "server1", base_ms=1.0, sigma=0.0).attach(coord)
        gate = _gated(plan)
        b = P.cl.Broker(coord)
        quiet(b)
        try_fire = b.hedge.try_fire

        def decide(opts=None):  # the primary waits for the hedge decision
            try:
                return try_fire(opts)
            finally:
                gate.set()

        b.hedge.try_fire = decide
        denied = b.query(hedged(SQL, budget_pct=0)).rows
        c1 = counters(P, "broker.hedgesLaunched", "broker.hedgesDenied")
        lone, _ = make_cluster(P, n_servers=2, replication=1, n_segments=2, rows=100)
        b2 = P.cl.Broker(lone)
        quiet(b2)
        inline = b2.query(hedged(SQL)).rows
        return {"denied": denied, "c1": c1, "inline": inline, "threads": len(b2._hedge_threads),
                "drained": b.hedge_drain(timeout_s=60), "c2": counters(P, "broker.hedgesLaunched"),
                "snapshot": b.hedge.snapshot()}

    out = run_both(scenario)
    p = out["port"]
    assert p["c1"] == {"broker.hedgesLaunched": 0, "broker.hedgesDenied": 1}
    assert p["threads"] == 0 and p["c2"]["broker.hedgesLaunched"] == 0 and p["drained"] == 0
    assert_parity(out)


def test_batched_hedging_is_exact_and_cancels_the_loser():
    sqls = [f"SELECT city, COUNT(*), SUM(v) FROM t WHERE v < {40 + i} GROUP BY city ORDER BY city"
            for i in range(4)]

    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=1, rows=300)
        expected = [r.rows for r in (P.cl.Broker(coord).query(q) for q in sqls)]
        plan = P.cl.FaultPlan(seed=7).jitter("server0", base_ms=1.0, sigma=0.0).jitter(
            "server1", base_ms=1.0, sigma=0.0).attach(coord)
        gate = _gated(plan)
        b = P.cl.Broker(coord)
        quiet(b)
        b.batch_clock = lambda: 0.0
        futs = [b.submit(hedged(q)) for q in sqls]
        flushed = b.drain_batches()
        outs = [f.result() for f in futs]
        gate.set()
        alive = b.hedge_drain(timeout_s=60)
        return {"rows": [o.rows for o in outs], "expected": expected, "flushed": flushed, "alive": alive,
                "hedged": [o.stats.hedged for o in outs],
                "counters": counters(P, "broker.hedgesLaunched", "broker.hedgesCancelled", "broker.batches",
                                     "broker.scatterServerFailures")}

    out = run_both(scenario)
    p = out["port"]
    assert p["rows"] == p["expected"] and p["alive"] == 0 and p["hedged"] == [1] * 4
    assert p["counters"] == {"broker.hedgesLaunched": 1, "broker.hedgesCancelled": 1, "broker.batches": 1,
                             "broker.scatterServerFailures": 0}
    assert_parity(out)


# ---------------------------------------------------------------------------
# the result cache, the hybrid split
# ---------------------------------------------------------------------------
def test_result_cache_hits_and_invalidates_on_churn():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=2, rows=100)
        b = P.cl.Broker(coord)
        q = "SET useResultCache = true; SELECT city, SUM(v) FROM t GROUP BY city ORDER BY city"
        r1, r2 = b.query(q), b.query(q)
        coord.add_segment("t", build(P, data(50, seed=9), "seg_new"))
        r3 = b.query(q)
        r4 = b.query(q.replace("true", "false"))
        dropped = b.invalidate_results("t")
        return {"tags": [getattr(r, "stats").result_cache for r in (r1, r2, r3)],
                "untagged": getattr(r4.stats, "result_cache", None),
                "rows": [r1.rows, r2.rows, r3.rows, r4.rows], "dropped": dropped}

    out = run_both(scenario)
    p = out["port"]
    assert p["tags"] == ["miss", "hit", "miss"] and p["rows"][0] == p["rows"][1] != p["rows"][2]
    assert_parity(out)


def test_hybrid_table_time_boundary(tmp_path):
    def scenario(P, d):
        coord = P.cl.Coordinator(replication=1)
        coord.register_server(P.server("s0"))
        stream = P.R.InMemoryStream(1)
        cfg = P.C.TableConfig(name="h", segments=P.C.SegmentsConfig(time_column="ts"),
                              stream=P.C.StreamConfig(stream_type="memory", max_rows_per_segment=1000))
        coord.add_realtime_table(schema(P, "h"), cfg, str(d / "h"), stream=stream)
        off = {"city": np.array(["sf"] * 10, dtype=object), "v": np.arange(10), "ts": (T0 + np.arange(10))}
        coord.add_segment("h", P.B.build_segment(schema(P, "h"), off, "off0", table_config=cfg))
        stream.publish_many([{"city": "sf", "v": int(i), "ts": T0 + i} for i in range(5, 20)], partition=0)
        coord.run_realtime_consumption()
        b = P.cl.Broker(coord)
        return {"all": b.query("SELECT COUNT(*), SUM(v) FROM h").rows,
                "late": b.query(f"SELECT COUNT(*) FROM h WHERE ts >= {T0 + 8}").rows}

    out = run_both(scenario, tmp_path)
    assert out["port"] == {"all": [(20, float(sum(range(20))))], "late": [(12,)]}
    assert_parity(out)


# ---------------------------------------------------------------------------
# the routes only the broker has: set ops, IN (SELECT ...), EXPLAIN
# ---------------------------------------------------------------------------
ROUTES = [
    "SELECT city FROM t WHERE v > 97 UNION ALL SELECT city FROM t WHERE v < 2",
    "SELECT city FROM t WHERE v > 90 UNION SELECT city FROM t WHERE v < 2",
    "SELECT city FROM t WHERE v > 50 INTERSECT SELECT city FROM t WHERE v < 10",
    "SELECT city FROM t WHERE v > 50 EXCEPT SELECT city FROM t WHERE city = 'sf'",
    "SELECT COUNT(*), SUM(v) FROM t WHERE city IN (SELECT city FROM t WHERE v > 98)",
    "SELECT COUNT(*) FROM t WHERE city NOT IN (SELECT city FROM t WHERE v = 97 AND city <> 'la')",
    "EXPLAIN PLAN FOR SELECT city, SUM(v) FROM t WHERE v > 3 GROUP BY city",
    "SET explainAnalyze = true; SELECT city, COUNT(*) FROM t GROUP BY city",
]


@pytest.mark.parametrize("sql", ROUTES, ids=[s[:48] for s in ROUTES])
def test_broker_only_routes(sql):
    def scenario(P, _d):
        coord, datas = make_cluster(P, n_servers=3, replication=2, n_segments=4, rows=200)
        res = P.cl.Broker(coord).query(sql)
        return {"columns": res.columns, "rows": sorted(res.rows, key=repr), "datas": datas}

    out = run_both(scenario)
    p = out["port"]
    # the port's segment engine over the same segments gives the same answer
    eng = PortEngine(device="cpu")
    eng.register_table(schema(pkg("port")), config(pkg("port")))
    for i, d in enumerate(p.pop("datas")):
        eng.add_segment("t", build(pkg("port"), d, f"seg{i}"))
    want = eng.query(sql)
    assert p["columns"] == want.columns
    explain = sql.startswith("EXPLAIN") or "explainAnalyze" in sql
    if explain and "explainAnalyze" in sql:
        # measured columns differ run to run: the operator tree must agree
        assert [r[:3] for r in p["rows"]] == sorted([r[:3] for r in want.rows], key=repr)
    else:
        assert_rows_match(p["rows"], sorted(want.rows, key=repr), ordered=True)
    j = out["jax"]
    j.pop("datas")
    assert p["columns"] == j["columns"] and len(p["rows"]) == len(j["rows"])
    if not explain:
        assert_rows_match(p["rows"], j["rows"], ordered=True)


# ---------------------------------------------------------------------------
# plan check, plan-cache budget, slow log
# ---------------------------------------------------------------------------
def test_plan_check_refuses_before_scatter():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=2, rows=30)
        plan = P.cl.FaultPlan(seed=0).attach(coord)
        b = P.cl.Broker(coord)
        with pytest.raises(Exception) as ei:
            b.query("SELECT SUM(nope) FROM t")
        return {"type": type(ei.value).__name__, "calls": [plan.calls(s) for s in ("server0", "server1")],
                "slow": [(e["sql"], e["error"].split(":")[0]) for e in b.slow_queries.snapshot()]}

    out = run_both(scenario)
    assert out["port"]["type"] == "PlanCheckError" and out["port"]["calls"] == [0, 0]
    assert_parity(out)


def test_broker_charges_the_plan_cache_to_its_governor():
    coord, _ = make_cluster(pkg("port"), n_servers=1, replication=1, n_segments=1, rows=30)
    b = pkg("port").cl.Broker(coord)
    assert port_planner._PLAN_CACHE.budget is b.governor.host_budget
    jc, _ = make_cluster(pkg("jax"), n_servers=1, replication=1, n_segments=1, rows=30)
    assert jax_planner._PLAN_CACHE.budget is pkg("jax").cl.Broker(jc).governor.host_budget
    assert b.autopilot is None and b.autopilot_snapshot()["enabled"] is False


# ---------------------------------------------------------------------------
# the micro-batch tier
# ---------------------------------------------------------------------------
SAME_SHAPE = [f"SELECT city, COUNT(*), SUM(v) FROM t WHERE v < {40 + i} GROUP BY city ORDER BY city"
              for i in range(5)]


def test_submit_drain_and_query_many_equal_their_own_queries():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=4, rows=200)
        b = P.cl.Broker(coord)
        b.batch_clock = lambda: 0.0  # groups flush only on drain
        futs = [b.submit(q) for q in SAME_SHAPE]
        pending = [f.done() for f in futs]
        flushed = b.drain_batches()
        batched = [f.result() for f in futs]
        many = [r.rows for r in b.query_many(SAME_SHAPE)]
        single = [b.query(q) for q in SAME_SHAPE]
        return {"pending": pending, "flushed": flushed, "batched": [r.rows for r in batched], "many": many,
                "single": [r.rows for r in single],
                "docs": [sum(r.stats.num_docs_scanned for r in batched), single[0].stats.num_docs_scanned],
                "total": [r.stats.total_docs for r in batched],
                "counters": counters(P, "broker.batches", "broker.batchFallbacks", "broker.memberServeErrors")}

    out = run_both(scenario)
    p = out["port"]
    assert p["pending"] == [False] * 5 and p["flushed"] >= 1
    assert p["batched"] == p["single"] == p["many"]
    assert p["docs"][0] == p["docs"][1] and p["counters"]["broker.batches"] == 2
    assert sum(port_executor.BATCH_AUDIT.snapshot().values()) > 0  # member-axis launches ran
    assert_parity(out)


def test_batch_bypasses_and_parse_errors():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=2, rows=100)
        b = P.cl.Broker(coord)
        b.batch_clock = lambda: 0.0
        done = []
        for q in ("EXPLAIN PLAN FOR SELECT COUNT(*) FROM t", ROUTES[0], ROUTES[4]):
            f = b.submit(q)
            done.append((f.done(), len(f.result().rows)))
        bad = b.submit("SELEKT nonsense")
        return {"done": done, "bad": (bad.done(), type(bad.exception()).__name__), "drained": b.drain_batches()}

    out = run_both(scenario)
    assert all(d[0] for d in out["port"]["done"]) and out["port"]["bad"][0]
    assert_parity(out)


def test_batched_member_with_an_expired_deadline_detaches():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=2, rows=200)
        b = P.cl.Broker(coord)
        b.batch_clock = lambda: 0.0
        sqls = list(SAME_SHAPE[:3])
        sqls[1] = "SET timeoutMs = 0; " + sqls[1]
        futs = [b.submit(q) for q in sqls]
        b.drain_batches()
        outs = []
        for f in futs:
            try:
                outs.append(f.result().rows)
            except Exception as e:  # the expired member's own error
                outs.append(type(e).__name__)
        return {"outs": outs, "want": [b.query(SAME_SHAPE[0]).rows, b.query(SAME_SHAPE[2]).rows]}

    out = run_both(scenario)
    p = out["port"]
    assert p["outs"][1] == "QueryTimeoutError" and [p["outs"][0], p["outs"][2]] == p["want"]
    assert_parity(out)


# ---------------------------------------------------------------------------
# metric federation
# ---------------------------------------------------------------------------
def _metric_lines(text):
    # timer/histogram series carry measured milliseconds; counters and
    # gauges are deterministic
    return [ln for ln in text.splitlines() if "_ms" not in ln]


def test_federation():
    def scenario(P, _d):
        coord, _ = make_cluster(P, n_servers=3, replication=2, n_segments=4, rows=100)
        b = P.cl.Broker(coord)
        for sql in QUERIES:
            b.query(sql)
        fed = b.federated_snapshot()
        per = {s: {"counters": snap["counters"], "gauges": snap["gauges"]} for s, snap in fed["perServer"].items()}
        text = b.federated_prometheus()
        cluster_lines = [ln for ln in _metric_lines(text) if ln.startswith("pinot_cluster_") or "server=" in ln]
        return {"per": per, "cluster": {"counters": fed["cluster"]["counters"], "gauges": fed["cluster"]["gauges"]},
                "lines": cluster_lines}

    out = run_both(scenario)
    p = out["port"]
    assert set(p["per"]) == {"server0", "server1", "server2"}
    assert any('server="server0"' in ln for ln in p["lines"])
    assert_parity(out)


def test_prometheus_export_and_merge_units():
    def registry(M):
        r = M.MetricsRegistry()
        r.counter("q.count").inc(3)
        r.gauge("mem bytes").add(12.5)
        for v in (0.5, 3.0, 250.0):
            r.histogram("lat").update(v)
        return r

    j = {s: registry(jax_metrics) for s in ("a", "b")}
    p = {s: registry(port_metrics) for s in ("a", "b")}
    assert port_metrics.merge_registry_snapshots(p) == jax_metrics.merge_registry_snapshots(j)
    assert p["a"].to_prometheus() == j["a"].to_prometheus()
    assert port_metrics.federate_prometheus(p) == jax_metrics.federate_prometheus(j)
    assert p["a"].histogram("lat").buckets() == j["a"].histogram("lat").buckets()
    assert_same(p["a"].snapshot()["counters"], j["a"].snapshot()["counters"])
