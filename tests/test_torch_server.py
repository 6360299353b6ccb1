"""The port's cluster/server.py ServerInstance against the JAX package's.

Both packages' servers hold segments built by their own builder from the
same data (4 segments, range and inverted indexes).  `execute` and
`execute_batch` must give the same rows (each package's reduce over the
server's segment results) and the same stats (segments queried / pruned /
processed, docs scanned, total docs); the batch's members must equal their
own `execute`.  A ResourceBudget too small for the working set raises
ReservationError; an expired or killed batch member detaches while its
siblings stay exact (tests/test_batching.py's cases); a crashed server
raises ServerFaultError until boot(); a FaultPlan that drops a segment, or
fails a call, fails the call as in the JAX server; a traced call shows the
dispatch / device_wait / collect spans.  The CPU server launches eagerly,
so its device_wait has nothing to wait for.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401
from pinot_tpu.cluster.admission import QueryKilledError as JaxKilled, ReservationError as JaxReservationError
from pinot_tpu.cluster.admission import ResourceBudget as JaxBudget
from pinot_tpu.cluster.faults import FaultPlan as JaxFaultPlan, ServerFaultError as JaxFaultError
from pinot_tpu.cluster.server import ServerInstance as JaxServer
from pinot_tpu.query.reduce import reduce_results as jax_reduce
from pinot_tpu.query.result import ExecutionStats as JaxStats
from pinot_tpu.query.safety import Deadline as JaxDeadline, QueryTimeoutError as JaxTimeout
from pinot_tpu.sql.parser import parse_query as jax_parse

from pinot_tpu_torch.cluster import FaultPlan, QueryKilledError, ReservationError, ServerFaultError, ServerInstance
from pinot_tpu_torch.cluster.admission import ResourceBudget
from pinot_tpu_torch.query import executor
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query.reduce import reduce_results as port_reduce
from pinot_tpu_torch.query.result import ExecutionStats as PortStats
from pinot_tpu_torch.query.safety import Deadline, QueryTimeoutError
from pinot_tpu_torch.sql.parser import parse_query as port_parse
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS

from test_torch_query import assert_rows_match, build_engines, make_data
from torch_port_state import port_state  # noqa: F401

SEGS = [f"t{i}" for i in range(4)]


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server) over the same 4 segments; the schemas."""
    datas = [make_data(30 + i, 700) for i in range(4)]
    datas[3]["year"][:] = 2023  # one segment a `year < k` filter prunes
    jx, port = build_engines({"t": (True, datas)})
    js, ps = JaxServer("s0"), ServerInstance("s0", device="cpu")
    for seg in jx.table("t").query_segments():
        js.add_segment("t", seg)
    for seg in port.table("t").query_segments():
        ps.add_segment("t", seg)
    return js, ps, jx.table("t").schema, port.table("t").schema


def _stats(st):
    return (st.num_segments_queried, st.num_segments_pruned, st.num_segments_processed, st.num_docs_scanned,
            st.total_docs)


def _rows(reduce, Stats, ctx, results):
    return reduce(ctx, results, Stats()).rows


QUERIES = [
    "SELECT city, SUM(v), COUNT(*) FROM t WHERE year < {k} GROUP BY city ORDER BY city",
    "SELECT COUNT(*), SUM(big), MIN(v) FROM t WHERE day BETWEEN {d} AND {d2}",
    "SELECT year, AVG(price) FROM t WHERE city = 'sf' AND year < {k} GROUP BY year ORDER BY year",
    "SELECT city, day FROM t WHERE day < {d} ORDER BY day, city LIMIT 20",
]


def _members(sql, n=4):
    return [sql.format(k=2004 + 4 * i, d=20 + 30 * i, d2=150 + 30 * i) for i in range(n)]


def _approx(sql):
    return (1,) if "AVG" in sql else ()


@pytest.mark.parametrize("sql", QUERIES)
def test_execute_matches_jax(servers, sql):
    js, ps, jschema, pschema = servers
    for q in _members(sql, 2):
        jres, jst = js.execute(jax_parse(q), SEGS, table_schema=jschema)
        pres, pst = ps.execute(port_parse(q), SEGS, table_schema=pschema)
        assert _stats(pst) == _stats(jst)
        assert_rows_match(_rows(port_reduce, PortStats, port_parse(q), pres),
                          _rows(jax_reduce, JaxStats, jax_parse(q), jres), approx=_approx(q), ordered=True)


@pytest.mark.parametrize("kernel_path", [False, True], ids=["torch_path", "kernel_op_path"])
@pytest.mark.parametrize("sql", QUERIES)
def test_execute_batch_matches_jax_and_execute(monkeypatch, servers, sql, kernel_path):
    js, ps, jschema, pschema = servers
    if kernel_path:
        monkeypatch.setattr(port_planner, "backend_tag", lambda device: "cuda")
    qs = _members(sql)
    jr, jst, jerr, _ = js.execute_batch([jax_parse(q) for q in qs], SEGS, table_schema=jschema)
    pr, pst, perr, _ = ps.execute_batch([port_parse(q) for q in qs], SEGS, table_schema=pschema)
    assert perr == [None] * len(qs) and jerr == perr
    for i, q in enumerate(qs):
        assert _stats(pst[i]) == _stats(jst[i])
        got = _rows(port_reduce, PortStats, port_parse(q), pr[i])
        assert_rows_match(got, _rows(jax_reduce, JaxStats, jax_parse(q), jr[i]), approx=_approx(q), ordered=True)
        own, _ = ps.execute(port_parse(q), SEGS, table_schema=pschema)
        assert_rows_match(got, _rows(port_reduce, PortStats, port_parse(q), own), approx=_approx(q), ordered=True)
    assert PORT_METRICS.snapshot()["counters"]["server.batches"] == 1


def test_batch_member_stats_sum_to_one_run(servers):
    _js, ps, _jschema, pschema = servers
    qs = _members(QUERIES[1])
    _r, stats, _e, _t = ps.execute_batch([port_parse(q) for q in qs], SEGS, table_schema=pschema)
    _res, one = ps.execute(port_parse(qs[0]), SEGS, table_schema=pschema)
    assert sum(s.num_docs_scanned for s in stats) == one.num_docs_scanned
    assert sum(s.kernel_bytes for s in stats) == pytest.approx(one.kernel_bytes, rel=1e-9)
    assert all(s.total_docs == one.total_docs for s in stats)


def test_batch_launches_once_a_segment(monkeypatch, servers):
    """On the kernel backend a batch of 4 reaches the fused scan once per
    scanned segment, with the member axis, where execute reaches it once
    per member and segment."""
    from pinot_tpu_torch.ops import fused_scan

    _js, ps, _jschema, pschema = servers
    monkeypatch.setattr(port_planner, "backend_tag", lambda device: "cuda")
    calls, sizes = [], []
    wrapper, op, rule = fused_scan.fused_group_tables, fused_scan._fused_op, fused_scan._fused_vmap

    def counting_wrapper(*args, **kw):
        calls.append(1)
        return wrapper(*args, **kw)

    def counting_rule(info, in_dims, *args):
        sizes.append(info.batch_size)
        return rule(info, in_dims, *args)

    monkeypatch.setattr(fused_scan, "fused_group_tables", counting_wrapper)
    op.register_vmap(counting_rule)
    try:
        qs = _members(QUERIES[0])
        ps.execute_batch([port_parse(q) for q in qs], SEGS, table_schema=pschema)
        # the fourth segment is pruned for every member
        assert sizes == [4, 4, 4] and len(calls) == 3
        for q in qs:
            ps.execute(port_parse(q), SEGS, table_schema=pschema)
    finally:
        op.register_vmap(rule)
    assert len(calls) == 3 + 4 * 3 and len(sizes) == 3


def test_reservation_error_when_budget_too_small(servers):
    js, ps, jschema, pschema = servers
    q = QUERIES[0].format(k=2020)
    ps.budget, js.budget = ResourceBudget(1000), JaxBudget(1000)
    try:
        with pytest.raises(JaxReservationError) as je:
            js.execute(jax_parse(q), SEGS, table_schema=jschema)
        with pytest.raises(ReservationError) as pe:
            ps.execute(port_parse(q), SEGS, table_schema=pschema)
        assert str(pe.value) == str(je.value)
        with pytest.raises(ReservationError):
            ps.execute_batch([port_parse(q)] * 2, SEGS, table_schema=pschema)
        assert ps.budget.in_use == 0
        ps.budget = ResourceBudget(1 << 30)
        ps.execute(port_parse(q), SEGS, table_schema=pschema)
        assert ps.budget.in_use == 0 and ps.budget.peak > 0
    finally:
        ps.budget = js.budget = None


@pytest.mark.parametrize("how", ["killed", "expired"])
def test_detached_member_leaves_siblings_exact(servers, how):
    js, ps, jschema, pschema = servers
    qs = _members(QUERIES[0], 5)
    bad = 2

    def run(server, parse, schema, Deadline_, reduce, Stats):
        kw = {}
        if how == "killed":
            kw["cancels"] = [(lambda: "killed by test") if i == bad else (lambda: None) for i in range(len(qs))]
        else:
            kw["deadlines"] = [Deadline_(0.0) if i == bad else None for i in range(len(qs))]
        res, _st, err, _t = server.execute_batch([parse(q) for q in qs], SEGS, table_schema=schema, **kw)
        rows = [None if err[i] else _rows(reduce, Stats, parse(q), res[i]) for i, q in enumerate(qs)]
        return [type(e).__name__ if e else None for e in err], [str(e) if e else None for e in err], rows

    jtypes, jmsgs, jrows = run(js, jax_parse, jschema, JaxDeadline, jax_reduce, JaxStats)
    ptypes, pmsgs, prows = run(ps, port_parse, pschema, Deadline, port_reduce, PortStats)
    assert ptypes == jtypes
    assert ptypes[bad] == ("QueryKilledError" if how == "killed" else "QueryTimeoutError")
    assert pmsgs == jmsgs
    for i, q in enumerate(qs):
        if i != bad:
            assert_rows_match(prows[i], jrows[i], ordered=True)


def test_whole_call_kill_and_timeout(servers):
    js, ps, jschema, pschema = servers
    q = QUERIES[0].format(k=2020)
    with pytest.raises(QueryKilledError) as pe:
        ps.execute(port_parse(q), SEGS, table_schema=pschema, cancel=lambda: "operator")
    with pytest.raises(JaxKilled) as je:
        js.execute(jax_parse(q), SEGS, table_schema=jschema, cancel=lambda: "operator")
    assert str(pe.value) == str(je.value)
    with pytest.raises(QueryTimeoutError) as pe:
        ps.execute(port_parse(q), SEGS, table_schema=pschema, deadline=Deadline(0.0))
    with pytest.raises(JaxTimeout) as je:
        js.execute(jax_parse(q), SEGS, table_schema=jschema, deadline=JaxDeadline(0.0))
    assert str(pe.value) == str(je.value)


def test_crashed_server_raises_until_boot():
    datas = [make_data(40, 300)]
    jx, port = build_engines({"t": (True, datas)})
    js, ps = JaxServer("s1"), ServerInstance("s1", device="cpu")
    js.add_segment("t", jx.table("t").query_segments()[0])
    ps.add_segment("t", port.table("t").query_segments()[0])
    for server, exc, parse in ((js, JaxFaultError, jax_parse), (ps, ServerFaultError, port_parse)):
        server.crash()
        assert server.segment_names("t") == []
        with pytest.raises(exc, match="s1 is down"):
            server.execute(parse("SELECT COUNT(*) FROM t"), ["t0"])
        with pytest.raises(exc, match="s1 is down"):
            server.execute_batch([parse("SELECT COUNT(*) FROM t")] * 2, ["t0"])
        server.boot()
        with pytest.raises(KeyError):
            server.execute(parse("SELECT COUNT(*) FROM t"), ["t0"])
    assert PORT_METRICS.snapshot()["counters"]["server.crashes"] == 1


def test_restore_segment_from_a_duck_typed_store(tmp_path):
    _jx, port = build_engines({"t": (True, [make_data(41, 300)])})
    seg = port.table("t").query_segments()[0]

    class Store:
        def fetch_segment(self, table, name, local_dir):
            assert (table, name) == ("t", "t0")
            return seg

    ps = ServerInstance("s2", device="cpu", data_dir=str(tmp_path))
    assert ps.restore_segment("t", "t0", Store()) is seg
    assert ps.segment_names("t") == ["t0"]
    res, st = ps.execute(port_parse("SELECT COUNT(*) FROM t"), ["t0"])
    assert st.num_docs_scanned == 300


@pytest.mark.parametrize("fault", ["drop_segment", "fail_call"])
def test_fault_plan(servers, fault):
    js, ps, jschema, pschema = servers
    q = QUERIES[0].format(k=2020)
    out = []
    for server, Plan, parse, schema, exc in ((js, JaxFaultPlan, jax_parse, jschema, JaxFaultError),
                                             (ps, FaultPlan, port_parse, pschema, ServerFaultError)):
        plan = Plan(seed=3)
        if fault == "drop_segment":
            plan.drop_segment("s0", "t", "t1")
        else:
            plan.fail_server("s0", on_call=1)
        server.fault_plan = plan
        try:
            with pytest.raises((KeyError, exc)) as ei:
                server.execute(parse(q), SEGS, table_schema=schema)
            out.append((type(ei.value).__name__.replace("Jax", ""), str(ei.value), plan.calls("s0")))
            _r, st = server.execute(parse(q), [s for s in SEGS if s != "t1"] if fault == "drop_segment" else SEGS,
                                    table_schema=schema)
            out.append(_stats(st))
        finally:
            server.fault_plan = None
    assert out[2:] == out[:2]


def test_traced_call_spans(servers):
    _js, ps, _jschema, pschema = servers
    q = "SET trace = true; " + QUERIES[0].format(k=2010)
    _res, st = ps.execute(port_parse(q), SEGS, table_schema=pschema)
    names = [c["name"] for c in st.trace["children"]]
    assert names[0] == "dispatch" and names[1] == "device_wait" and names[2:] == ["collect"] * 3
    disp = st.trace["children"][0]
    assert [c["name"] for c in disp["children"]] == ["launch:t0", "launch:t1", "launch:t2"]
    assert disp["children"][0]["attrs"]["kernelBytes"] > 0
    assert st.trace["attrs"]["backend"] == "torch" and st.trace["attrs"]["segmentsPruned"] == 1
    assert st.device_ms >= 0.0
    _r, _s, _e, bt = ps.execute_batch([port_parse(x) for x in _members(QUERIES[0], 3)], SEGS,
                                      table_schema=pschema, batch_id="b1", trace_enabled=True)
    assert [c["name"] for c in bt["children"]] == ["dispatch", "device_wait", "collect", "collect", "collect"]
    assert bt["attrs"]["batchSize"] == 3


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServerInstance("s9")


def test_drop_segment_releases_it(servers):
    _jx, port = build_engines({"t": (True, [make_data(42, 200)])})
    ps = ServerInstance("s3", device="cpu")
    seg = port.table("t").query_segments()[0]
    ps.add_segment("t", seg)
    ps.execute(port_parse("SELECT COUNT(*) FROM t"), ["t0"])
    gauge = PORT_METRICS.snapshot()["gauges"]["server.segmentBytes.t"]
    assert gauge > 0
    ps.drop_segment("t", "t0")
    assert ps.get_segment("t", "t0") is None
    assert PORT_METRICS.snapshot()["gauges"]["server.segmentBytes.t"] == 0
    assert executor.pending_outputs([]) == []
