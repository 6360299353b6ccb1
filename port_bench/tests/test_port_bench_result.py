"""A whole run on the CPU at a tiny size, with the harness's look for a
card skipped: the last line's keys, and `correct` coming out false when
the timed path is broken underneath (each fault a query system can have:
half of the work left out, an answer altered where it is produced) or
when the reference's float32 control stands in the program's place."""
import json
import sys

import pytest

from _tiny import REPO, SEED, tiny
from port_bench.reference import ssb_numpy as ref

sys.path.insert(0, str(REPO / "port_bench"))
import run  # noqa: E402

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def _run(workload, trace=0, wrap=None, seconds=1.0):
    res = run.run_cell(tiny(workload), SEED, seconds, trace, device="cpu", wrap=wrap)
    json.dumps(res)  # one JSON object
    return res


WORKLOADS = ["ssb_flat_sf10.power_c1"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line(workload):
    res = _run(workload)
    assert set(res) == KEYS and list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    cell = tiny(workload)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["compared"]["wrong_rows"] == {"value": 0, "limit": 0}


def test_traced_result_line():
    res = _run("ssb_flat_sf10.power_c1", trace=1)
    assert set(res) == KEYS | {"breakdown"} and list(res)[-1] == "compared"
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the device readers find nothing; the span readers do
    assert {"broker.self_ms", "server.scatter_ms", "fused_scan.launches_per_query", "stream.qps",
            "stream.latency_p50_ms"} <= set(res["metrics"])
    assert "fused_scan.roofline_pct" not in res["metrics"]


class _Rows:
    """A result whose rows are replaced (the stats kept)."""

    def __init__(self, out, rows):
        self.stats, self.rows = out.stats, rows


def _altered(query):
    """An answer altered where it is produced: the first row's aggregate
    (its last float) one more."""
    def alter(row):
        at = max(i for i, v in enumerate(row) if isinstance(v, float))
        return row[:at] + (row[at] + 1,) + row[at + 1:]

    def q(sql):
        out = query(sql)
        return _Rows(out, [alter(r) if i == 0 else r for i, r in enumerate(out.rows)])
    return q


def _half(query):
    """Half of the work left out: every sum halved, the rows kept."""
    def q(sql):
        out = query(sql)
        return _Rows(out, [tuple(v / 2 if isinstance(v, float) else v for v in r) for r in out.rows])
    return q


@pytest.mark.parametrize("fault", [_altered, _half], ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_makes_it_incorrect(workload, fault):
    res = _run(workload, wrap=fault)
    assert res["correct"] is False
    assert res["failed"] > 0
    assert res["compared"]["sum_gap"]["value"] > 0 or res["compared"]["wrong_rows"]["value"] > 0


def test_float32_control_is_incorrect():
    """The reference in float32 put in the program's place: at this size
    too it reads a gap above the exact limit."""
    cell = tiny("ssb_flat_sf10.power_c1")
    low = ref.answer(SEED, 1, 2, 3000, list(cell.queries), dtype="float32")

    class Control:
        def __init__(self, qid):
            self.rows, self.stats = low[qid], None

    by_sql = {sql: qid for qid, sql in cell.queries.items()}

    def control(_query):
        return lambda sql: Control(by_sql[sql])

    res = run.run_cell(cell, SEED, 1.0, 0, device="cpu", wrap=control)
    assert res["correct"] is False and res["compared"]["sum_gap"]["value"] > 0
