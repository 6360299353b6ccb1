"""The port's cluster/rest.py against the JAX package's.

Each scenario starts the package's QueryServer on 127.0.0.1 (port 0) over
an engine or a Broker of that package, sends the same requests, and returns
what came back: status codes, content types and JSON payloads.  The two
packages' payloads must be equal apart from `timeUsedMs`, `requestId` and
`trace` (a wall time, a minted id and a span tree of wall times); query
rows are held to each other exactly by `assert_rows_match` (cells and
types).  The port's servers and engines run on the CPU.

Mirrored: tests/test_tools.py's REST and cursor cases, the REST cases of
test_observability.py, test_overload.py, test_fault_tolerance.py,
test_autopilot.py, test_leader_election.py, test_perf_observatory.py and
test_plan_check.py.  Added: the table quota's 429, the 404 paths, a 0-d
tensor in a result row, and eight concurrent clients.

`spkg(name)` extends test_torch_coordinator.pkg with the serving modules
(rest, minion, mview, cli, perf, admission, the engine) for the other
serving-surface test files.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pinot_tpu.cluster import admission as jax_adm
from pinot_tpu.cluster import autopilot as jax_autopilot
from pinot_tpu.cluster import minion as jax_minion
from pinot_tpu.cluster import mview as jax_mview
from pinot_tpu.cluster import rest as jax_rest
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.query.result import ExecutionStats as JaxStats, ResultTable as JaxResult
from pinot_tpu.segment.segment import ImmutableSegment as JaxSegment
from pinot_tpu.tools import cli as jax_cli
from pinot_tpu.utils import perf as jax_perf

from pinot_tpu_torch.cluster import admission as port_adm
from pinot_tpu_torch.cluster import autopilot as port_autopilot
from pinot_tpu_torch.cluster import minion as port_minion
from pinot_tpu_torch.cluster import mview as port_mview
from pinot_tpu_torch.cluster import rest as port_rest
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.query.result import ExecutionStats as PortStats, ResultTable as PortResult
from pinot_tpu_torch.segment.segment import ImmutableSegment as PortSegment
from pinot_tpu_torch.tools import cli as port_cli
from pinot_tpu_torch.utils import perf as port_perf

from test_torch_coordinator import (  # noqa: F401  (fixtures)
    _jax_kill_points, build, config, data, make_cluster, pkg, port_state, quiet, schema,
)
from test_torch_query import assert_rows_match

PKGS = ("jax", "port")
TIMING_FIELDS = ("timeUsedMs", "requestId", "trace")
SQL = "SELECT city, COUNT(*), SUM(v) FROM t GROUP BY city ORDER BY city"


def spkg(name):
    """pkg(name) plus the serving surface: rest, minion, mview, cli, perf,
    admission, autopilot, ExecutionStats, ResultTable, ImmutableSegment and
    an engine factory (the port's on the CPU)."""
    P = pkg(name)
    if name == "jax":
        P.rest, P.minion, P.mview, P.cli, P.perf = jax_rest, jax_minion, jax_mview, jax_cli, jax_perf
        P.adm, P.autopilot, P.Stats, P.Result, P.Seg = jax_adm, jax_autopilot, JaxStats, JaxResult, JaxSegment
        P.engine = lambda **kw: JaxEngine(**kw)
        P.device_args = []
    else:
        P.rest, P.minion, P.mview, P.cli, P.perf = port_rest, port_minion, port_mview, port_cli, port_perf
        P.adm, P.autopilot, P.Stats, P.Result, P.Seg = port_adm, port_autopilot, PortStats, PortResult, PortSegment
        P.engine = lambda **kw: PortEngine(device="cpu", **kw)
        P.device_args = ["--device", "cpu"]
    return P


def both(scenario, *args):
    return {name: scenario(spkg(name), *args) for name in PKGS}


class Served:
    """A package's QueryServer over `engine` for the length of a with-block."""

    def __init__(self, P, engine):
        self.srv = P.rest.QueryServer(engine)
        self.client = P.rest.PinotClient(f"http://127.0.0.1:{self.srv.port}")
        self.base = f"http://127.0.0.1:{self.srv.port}"

    def __enter__(self):
        self.srv.start()
        return self

    def __exit__(self, *exc):
        self.srv.stop()

    def post(self, body, path="/query/sql"):
        req = urllib.request.Request(self.base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    def get(self, path):
        """(status, content type, body text)."""
        try:
            with urllib.request.urlopen(self.base + path) as r:
                return r.status, r.headers.get("Content-Type", ""), r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Content-Type", ""), e.read().decode()

    def get_json(self, path):
        code, _, body = self.get(path)
        return code, json.loads(body)


def stable(payload):
    """A payload less its timing fields, rows kept aside for assert_rows_match."""
    out = {k: v for k, v in payload.items() if k not in TIMING_FIELDS}
    if "resultTable" in out:
        out["resultTable"] = dict(out["resultTable"])
        out["rows"] = out["resultTable"].pop("rows")
    return out


def without_id(payload):
    """An error payload less its minted query id, in `requestId` and in the
    message."""
    qid = payload["requestId"]
    assert qid
    return {k: (v.replace(qid, "<qid>") if k == "error" else v) for k, v in payload.items() if k != "requestId"}


def assert_payloads(got, want):
    g, w = stable(got), stable(want)
    rows_g, rows_w = g.pop("rows", None), w.pop("rows", None)
    assert g == w
    if rows_w is not None:
        assert_rows_match([tuple(r) for r in rows_g], [tuple(r) for r in rows_w], ordered=True)


def engine(P, n=5000, seed=5):
    """The JAX REST tests' engine: table t (city, v) by DDL, one segment."""
    eng = P.engine()
    eng.sql("CREATE TABLE t (city STRING, v LONG METRIC)")
    rng = np.random.default_rng(seed)
    d = {"city": rng.choice(["sf", "nyc"], n).astype(object), "v": rng.integers(0, 100, n)}
    eng.add_segment("t", P.B.build_segment(eng.table("t").schema, d, "s0"))
    return eng


# ---------------------------------------------------------------------------
# query, health, metrics, cursors
# ---------------------------------------------------------------------------
def test_query_endpoint():
    def scenario(P):
        with Served(P, engine(P)) as s:
            resp = s.client.execute("SELECT city, COUNT(*), SUM(v) FROM t GROUP BY city ORDER BY city")
            assert resp["timeUsedMs"] > 0 and resp["requestId"]
            code, plain = s.post({"sql": "SELECT COUNT(*), SUM(v) FROM t"}, path="/query")
            return resp, code, plain

    out = both(scenario)
    (pj, cj, plj), (pp, cp, plp) = out["jax"], out["port"]
    assert pp["resultTable"]["dataSchema"]["columnNames"] == ["city", "count(*)", "sum(v)"]
    assert pp["numDocsScanned"] == 5000 and cp == cj == 200
    assert_payloads(pp, pj)
    assert_payloads(plp, plj)


def test_health_and_metrics_json():
    def scenario(P):
        with Served(P, engine(P)) as s:
            s.client.execute("SELECT COUNT(*) FROM t")
            code, health = s.get_json("/health")
            mcode, ctype, body = s.get("/metrics")
            return code, health, mcode, ctype.split(";")[0], set(json.loads(body))

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"status": "OK"} and {"counters", "histograms"} <= out["port"][4]


def test_prometheus_format():
    def scenario(P):
        with Served(P, engine(P)) as s:
            s.post({"sql": "SELECT COUNT(*) FROM t"})
            code, ctype, text = s.get("/metrics?format=prometheus")
            return code, ctype, "pinot_queries_total" in text, 'pinot_queryLatency_ms_bucket{le="+Inf"} 1' in text

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1].startswith("text/plain") and out["port"][2] and out["port"][3]


def test_error_payload_500():
    def scenario(P):
        with Served(P, engine(P)) as s:
            with pytest.raises(urllib.error.HTTPError) as ei:
                s.client.execute("SELECT FROM nowhere")
            return ei.value.code, json.loads(ei.value.read().decode())

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 500


def test_cursor_paging():
    def scenario(P):
        with Served(P, engine(P)) as s:
            resp = s.client.execute("SELECT city, v FROM t LIMIT 250", useCursor=True, pageSize=100)
            cid = resp["cursorId"]
            pages = [s.client.fetch_cursor(cid, p) for p in range(3)]
            missing = s.get_json("/cursors/nope/0")
            return resp, pages, missing

    out = both(scenario)
    (rj, pj, mj), (rp, pp, mp) = out["jax"], out["port"]
    assert len(rp["resultTable"]["rows"]) == 100
    assert_payloads({k: v for k, v in rp.items() if k != "cursorId"}, {k: v for k, v in rj.items() if k != "cursorId"})
    assert [(p["totalRows"], p["numPages"], p["page"], len(p["rows"])) for p in pp] == [
        (250, 3, 0, 100), (250, 3, 1, 100), (250, 3, 2, 50)]
    for got, want in zip(pp, pj):
        assert {k: v for k, v in got.items() if k not in ("cursorId", "rows")} == {
            k: v for k, v in want.items() if k not in ("cursorId", "rows")}
        assert_rows_match([tuple(r) for r in got["rows"]], [tuple(r) for r in want["rows"]], ordered=True)
    assert pp[0]["rows"] == rp["resultTable"]["rows"]
    assert mp == mj and mp[0] == 404


def test_unknown_paths_and_missing_views():
    """404s: unknown GET / POST paths, and the debug views an engine does
    not have (a QueryEngine has a slow log and the perf ledger, no governor,
    autopilot or election view)."""

    def scenario(P):
        with Served(P, engine(P)) as s:
            out = {p: s.get_json(p) for p in ("/nope", "/debug/admission", "/debug/autopilot", "/debug/election")}
            out["post"] = s.post({"sql": "SELECT 1"}, path="/elsewhere")
            return out

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert {v[0] for v in out["port"].values()} == {404}


def test_debug_queries_and_request_id():
    def scenario(P):
        with Served(P, engine(P)) as s:
            resp = s.client.execute("SELECT COUNT(*) FROM t")
            code, body = s.get_json("/debug/queries?limit=5")
            e = body["queries"][0]
            assert e["queryId"] == resp["requestId"] and resp["requestId"].startswith("engine_")
            return code, len(body["queries"]), e["sql"], e["rows"], e["numDocsScanned"], sorted(e)

    out = both(scenario)
    assert out["port"] == out["jax"]


def test_debug_perf_on_plain_engine():
    def scenario(P):
        with Served(P, engine(P)) as s:
            s.post({"sql": "SELECT COUNT(*) FROM t"}, path="/query")
            code, payload = s.get_json("/debug/perf")
            shape = next(iter(payload["tables"]["t"]["shapes"].values()))
            return code, sorted(payload), payload["tables"]["t"]["queries"], sorted(shape)

    out = both(scenario)
    assert out["port"] == out["jax"]


def test_broker_response_unwraps_scalars():
    """numpy scalars, 0-d tensors (the port), bytes, NaN and tuples become
    JSON values; the payload has the JAX package's keys and values."""

    def scenario(P):
        st = P.Stats(num_docs_scanned=7, total_docs=9, query_id="q1", time_ms=1.25)
        rows = [(np.int64(3), np.float64(2.5), b"ab", float("nan"), (np.int32(1), 2))]
        if P.name == "port":
            rows.append((torch.tensor(4), torch.tensor(1.5, dtype=torch.float64), b"c", 1.0, (3,)))
        else:
            rows.append((np.int64(4), np.float64(1.5), b"c", 1.0, (3,)))
        payload = P.rest.broker_response(P.Result(["a", "b", "c", "d", "e"], rows, st))
        return json.loads(json.dumps(payload))

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"]["resultTable"]["rows"][1] == [4, 1.5, "c", 1.0, [3]]


# ---------------------------------------------------------------------------
# through a Broker: federation, debug views, the error mapping
# ---------------------------------------------------------------------------
def test_broker_metrics_federation_and_perf():
    def scenario(P):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=4)
        broker = P.cl.Broker(coord)
        broker.query("SELECT COUNT(*) FROM t")
        with Served(P, broker) as s:
            code, ctype, text = s.get("/metrics?format=prometheus")
            jcode, snap = s.get_json("/metrics")
            pcode, perf = s.get_json("/debug/perf")
            return {"prom": (code, ctype, 'server="server0"' in text, 'server="server1"' in text,
                             "pinot_cluster_" in text),
                    "json": (jcode, sorted(snap), sorted(snap["servers"]), sorted(snap["servers"]["perServer"])),
                    "queries": snap["servers"]["cluster"]["counters"].get("server.queries"),
                    "perf": (pcode, sorted(perf), sorted(perf["tables"]), perf["tables"]["t"]["queries"])}

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert all(out["port"]["prom"][2:])


def test_concurrent_clients_exact():
    """Eight clients on threads against one broker: each answer equals the
    sequential one (handler threads share the broker, its caches and the
    launch counters)."""

    def scenario(P):
        coord, _ = make_cluster(P, n_servers=3, replication=2, n_segments=4)
        broker = P.cl.Broker(coord)
        want = broker.query(SQL).rows
        with Served(P, broker) as s:
            got, errors = [None] * 8, []

            def client(i):
                try:
                    got[i] = s.client.execute(f"SET useResultCache = false; {SQL}")["resultTable"]["rows"]
                except Exception as e:  # surfaced below
                    errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads) and not errors, errors
        return want, got

    out = both(scenario)
    for name in PKGS:
        want, got = out[name]
        for rows in got:
            assert_rows_match([tuple(r) for r in rows], want, ordered=True)
    assert_rows_match(out["port"][0], out["jax"][0], ordered=True)


def test_timeout_maps_to_408():
    def scenario(P):
        coord, _ = make_cluster(P, n_servers=1, replication=1, n_segments=1)
        with Served(P, P.cl.Broker(coord)) as s:
            return s.post({"sql": "SET timeoutMs = 0; SELECT COUNT(*) FROM t"})

    out = both(scenario)
    assert out["port"][0] == 408 and out["port"][1]["errorCode"] == "EXECUTION_TIMEOUT_ERROR"
    assert out["port"] == out["jax"]


def test_admission_maps_to_503():
    def scenario(P):
        eng = P.engine(memory_budget_bytes=512)  # nothing fits
        eng.register_table(schema(P))
        eng.add_segment("t", build(P, data(2000, seed=1), "s0"))
        with Served(P, eng) as s:
            return s.post({"sql": "SELECT SUM(v) FROM t"})

    out = both(scenario)
    assert out["port"][0] == 503 and out["port"][1]["errorCode"] == "SERVER_RESOURCE_LIMIT_EXCEEDED"
    assert out["port"] == out["jax"]


def test_partial_result_surfaced_at_200():
    def scenario(P):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=4)
        P.cl.FaultPlan(seed=4).always_fail("server0").attach(coord)
        broker = P.cl.Broker(coord)
        quiet(broker)
        with Served(P, broker) as s:
            return s.post({"sql": "SET allowPartialResults = true; SELECT COUNT(*) FROM t"})

    out = both(scenario)
    code, payload = out["port"]
    assert code == 200 and payload["partialResult"] is True and payload["exceptions"]
    assert payload["numServersResponded"] < payload["numServersQueried"]
    assert out["port"][0] == out["jax"][0]
    assert_payloads(out["port"][1], out["jax"][1])


def test_scatter_error_maps_to_500():
    def scenario(P):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=4)
        P.cl.FaultPlan(seed=4).always_fail("server0").attach(coord)
        broker = P.cl.Broker(coord)
        quiet(broker)
        with Served(P, broker) as s:
            return s.post({"sql": "SET maxScatterRetries = 0; SELECT COUNT(*) FROM t"})

    out = both(scenario)
    assert out["port"][0] == 500 and out["port"][1]["errorCode"] == "SERVER_SCATTER_ERROR"
    assert out["port"][1]["exceptions"]
    assert out["port"] == out["jax"]


def test_no_replica_maps_to_503():
    def scenario(P):
        coord, _ = make_cluster(P, n_servers=2, replication=1, n_segments=4)
        P.cl.FaultPlan(seed=4).always_fail("server0").attach(coord)
        broker = P.cl.Broker(coord)
        quiet(broker)
        with Served(P, broker) as s:
            return s.post({"sql": "SELECT COUNT(*) FROM t"})

    out = both(scenario)
    assert out["port"][0] == 503 and out["port"][1]["errorCode"] == "NO_REPLICA_AVAILABLE"
    assert out["port"] == out["jax"]


def test_table_quota_maps_to_429():
    def scenario(P):
        coord, _ = make_cluster(P, n_servers=1, replication=1, n_segments=0)
        coord.add_table(schema(P, "q"), config(P, "q", max_queries_per_second=1.0))
        coord.add_segment("q", P.B.build_segment(schema(P, "q"), data(100, seed=3), "q0"))
        broker = P.cl.Broker(coord)
        broker.quota.clock = lambda: 1000.0  # frozen: the second query finds no token
        with Served(P, broker) as s:
            return [s.post({"sql": "SELECT COUNT(*) FROM q"}) for _ in range(2)]

    out = both(scenario)
    (c1, p1), (c2, p2) = out["port"]
    assert (c1, c2) == (200, 429) and p2["errorCode"] == "QUERY_QUOTA_EXCEEDED"
    assert_payloads(p1, out["jax"][0][1])
    assert out["port"][1] == out["jax"][1]


def _governor(P, **kw):
    a = P.adm
    return a.ResourceGovernor(
        admission=a.AdmissionController(rate_units_per_s=kw.get("rate", 0.0), burst_units=kw.get("burst"),
                                        max_queue=kw.get("max_queue", 8)),
        host_budget=a.ResourceBudget(1 << 30, gauge="admission.hostReservedBytes"),
        watchdog=a.QueryWatchdog(runaway_ms=0.0, pressure_kill_at=0.0),
        degrade=a.DegradationController(),
    )


def test_shed_maps_to_429_with_request_id():
    def scenario(P):
        broker = P.cl.Broker(make_cluster(P, n_servers=2, replication=2, n_segments=4)[0])
        gov = _governor(P, rate=1.0, burst=1e-9, max_queue=0)
        gov.admission.clock = lambda: 0.0
        gov.admission.admit("drain")  # the initial burst
        broker.governor = gov  # frozen clock: the POST below sheds
        with Served(P, broker) as s:
            code, payload = s.post({"sql": SQL})
        return code, without_id(payload)

    out = both(scenario)
    assert out["port"][0] == 429 and out["port"][1]["errorCode"] == "TOO_MANY_REQUESTS_ERROR"
    assert out["port"] == out["jax"]


def test_capacity_maps_to_503_out_of_capacity():
    def scenario(P):
        coord, _ = make_cluster(P, n_servers=2, replication=2, n_segments=4)
        for srv in coord.servers.values():
            srv.budget = P.adm.ResourceBudget(16)
        broker = P.cl.Broker(coord)
        quiet(broker)
        with Served(P, broker) as s:
            code, payload = s.post({"sql": SQL})
        return code, without_id(payload)

    out = both(scenario)
    assert out["port"][0] == 503 and out["port"][1]["errorCode"] == "SERVER_OUT_OF_CAPACITY"
    assert out["port"] == out["jax"]


def test_kill_maps_to_503_query_killed_and_partial_at_200():
    def scenario(P):
        broker = P.cl.Broker(make_cluster(P, n_servers=2, replication=2, n_segments=4)[0])
        broker.query(SQL)  # warm
        with Served(P, broker) as s:
            killed = s.post({"sql": "SET maxRuntimeMs = 0.001; " + SQL})
            partial = s.post({"sql": "SET allowPartialResults = true; SET maxRuntimeMs = 0.001; " + SQL})
        return killed, partial

    out = both(scenario)
    for name in PKGS:
        (kc, kp), (pc, pp) = out[name]
        assert kc == 503 and kp["errorCode"] == "QUERY_KILLED" and kp["requestId"] and "runaway" in kp["reason"]
        assert pc == 200 and pp["partialResult"] is True
        assert any(e.get("errorCode") == "QUERY_KILLED" for e in pp["exceptions"])
    assert sorted(out["port"][0][1]) == sorted(out["jax"][0][1])


def test_debug_admission_snapshot():
    def scenario(P):
        broker = P.cl.Broker(make_cluster(P, n_servers=2, replication=2, n_segments=2)[0])
        with Served(P, broker) as s:
            code, payload = s.get_json("/debug/admission")
        assert payload["hostBudget"]["budgetBytes"] > 0
        return code, sorted(payload), {k: sorted(v) if isinstance(v, dict) else None for k, v in payload.items()}

    out = both(scenario)
    assert out["port"][0] == 200 and set(out["port"][1]) >= {"pressureLevel", "admission", "hostBudget", "watchdog"}
    assert out["port"] == out["jax"]


def test_plan_check_maps_to_structured_400():
    def scenario(P):
        eng = P.engine()
        eng.sql("CREATE TABLE demo (city STRING, amount DOUBLE METRIC)")
        eng.add_segment("demo", P.B.build_segment(eng.table("demo").schema, {
            "city": np.array(["a", "b"], dtype=object), "amount": np.array([1.0, 2.0])}, "d0"))
        with Served(P, eng) as s:
            return s.post({"sql": "SELECT SUM(MAX(amount)) FROM demo"})

    out = both(scenario)
    assert out["port"][0] == 400 and out["port"][1]["errorCode"] == "NESTED_AGGREGATION"
    assert out["port"] == out["jax"]


def test_debug_autopilot_detached_and_attached():
    def scenario(P):
        broker = P.cl.Broker(make_cluster(P, n_servers=2, replication=2, n_segments=2)[0])
        with Served(P, broker) as s:
            _, detached = s.get_json("/debug/autopilot")
            broker.attach_autopilot()  # not started: tick() driven by hand
            broker.autopilot.tick()
            code, attached = s.get_json("/debug/autopilot")
        broker.attach_autopilot(controller=None)
        return {"detached": (detached["enabled"], sorted(detached["knobs"]),
                             sorted(detached["knobs"]["batch_wait_ms"])),
                "attached": (code, attached["enabled"], attached["ticks"], attached["decisions"][-1]["action"],
                             attached["changeBound"], sorted(attached))}

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"]["detached"][0] is False and out["port"]["attached"][1] is True


class _LeaderlessEngine:
    """An engine whose control plane lost leadership: its election view
    answers, its queries raise NotLeaderError."""

    def __init__(self, P, snapshot):
        self.P, self.snap = P, snapshot

    def election_snapshot(self):
        return self.snap

    def sql(self, _sql):
        raise self.P.election.NotLeaderError("coordinator coord-a is a standby")


ELECTION_SNAPSHOT = {"leader": "coord-a", "candidates": [
    {"node": "coord-a", "role": "leader", "epoch": 1, "journalSeq": 4, "ttl_s": 5.0, "paused": False,
     "lease": {"holder": "coord-a", "epoch": 1, "expiresIn_s": 4.5}},
    {"node": "coord-b", "role": "standby", "epoch": 1, "ttl_s": 5.0, "paused": True, "lease": None}]}


def test_debug_election_and_not_leader_503():
    def scenario(P):
        with Served(P, _LeaderlessEngine(P, ELECTION_SNAPSHOT)) as s:
            return s.get_json("/debug/election"), s.post({"sql": "SELECT 1"})

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (200, ELECTION_SNAPSHOT)
    assert out["port"][1][0] == 503 and out["port"][1][1]["errorCode"] == "NOT_LEADER"


def test_broker_election_snapshot_over_rest(tmp_path):
    """A durable coordinator's own election view through Broker and REST."""

    def scenario(P):
        d = tmp_path / P.name
        coord = P.cl.Coordinator(replication=1, meta_dir=str(d / "meta"), node_id="coord-a")
        coord.register_server(P.server("server0"))
        with Served(P, P.cl.Broker(coord)) as s:
            code, snap = s.get_json("/debug/election")
        cand = snap["candidates"][0]
        return code, snap["leader"], cand["role"], cand["epoch"], sorted(cand)

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][:4] == (200, "coord-a", "leader", 1)


def test_every_replica_of_a_segment_fails():
    """Both replicas of a segment fail every call (three servers,
    replication 2, as chip_smoke.py's phase 4l scripts it): the packages
    answer with the same status and error code; detached, the next query
    is whole again."""

    def scenario(P):
        coord, _ = make_cluster(P, n_servers=3, replication=2, n_segments=4)
        broker = P.cl.Broker(coord)
        slept = quiet(broker)
        victims = sorted(coord.tables["t"].ideal["seg0"])
        plan = P.cl.FaultPlan(seed=5)
        for v in victims:
            plan.always_fail(v)
        plan.attach(coord)
        with Served(P, broker) as s:
            code, payload = s.post({"sql": SQL})
            for srv in coord.servers.values():
                srv.fault_plan = None
            for v in victims:
                broker.health.reset(v)
            healed = s.post({"sql": SQL})
        return victims, code, payload, len(slept), healed[0], healed[1]["resultTable"]["rows"]

    out = both(scenario)
    victims, code, payload, retries, hcode, rows = out["port"]
    assert code in (500, 503) and payload["errorCode"] in ("SERVER_SCATTER_ERROR", "NO_REPLICA_AVAILABLE")
    assert hcode == 200
    assert (victims, code, payload, retries, hcode) == out["jax"][:5]
    assert_rows_match([tuple(r) for r in rows], [tuple(r) for r in out["jax"][5]], ordered=True)
