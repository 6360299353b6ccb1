"""The port's metrics registry and perf ledger against the JAX package's.

The same sequence of updates goes into a fresh registry (ledger) of each
package; their snapshots must be equal, except the ledger's QPS, which
reads the wall clock between records (checked for shape only).  The
analytic byte model of both packages must agree on segments built from the
same data, and both segment engines must record the same kernel bytes for
the same query.
"""
import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.utils import metrics as jax_metrics
from pinot_tpu.utils import perf as jax_perf

from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.utils import metrics as port_metrics
from pinot_tpu_torch.utils import perf as port_perf

from test_torch_query import make_config, make_data, make_schema


def _drive_registry(reg):
    reg.counter("dist.queries").inc()
    reg.counter("dist.queries").inc(4)
    reg.counter("engine.prefetchHits").inc(3)
    reg.gauge("residency.residentBytes").set(1234)
    reg.gauge("hbm.pinned").add(10.5)
    reg.gauge("hbm.pinned").add(-0.5)
    for ms in (0.05, 0.3, 1.7, 12.0, 250.0, 90_000.0):
        reg.histogram("dist.queryLatency").update(ms)
        reg.timer("stage").update(ms)
    reg.histogram("residency.stagingStallMs")  # registered, never updated
    return reg.snapshot()


def test_registry_snapshot_matches_jax():
    got = _drive_registry(port_metrics.MetricsRegistry())
    want = _drive_registry(jax_metrics.MetricsRegistry())
    assert got == want


def test_registry_reset_matches_jax():
    for mod in (port_metrics, jax_metrics):
        reg = mod.MetricsRegistry()
        _drive_registry(reg)
        reg.reset()
        assert reg.snapshot() == {"counters": {}, "gauges": {}, "timers": {}, "histograms": {}}


def _drive_ledger(ledger):
    ledger.record("t", "aaa", rows=1_000_000, time_ms=4.0, kernel_bytes=6e6, compile_ms=2.5, cache_hit=False)
    ledger.record("t", "aaa", rows=1_000_000, time_ms=2.0, kernel_bytes=6e6, cache_hit=True)
    ledger.record("t", "bbb", rows=10, time_ms=0.0)
    ledger.record("", "", rows=5, time_ms=1.0, kernel_bytes=0.0)
    snap = ledger.snapshot()
    for t in snap["tables"].values():
        t.pop("qps")
        for shape in t["shapes"].values():
            assert shape.pop("qps") >= 0.0
            shape.pop("rooflinePct")  # against each package's own device peak
    return snap


def test_ledger_snapshot_matches_jax():
    assert _drive_ledger(port_perf.PerfLedger(window=4)) == _drive_ledger(jax_perf.PerfLedger(window=4))


def test_roofline_is_against_the_h100_peak():
    # 3.35e12 B in one second is the card's whole HBM rate
    assert port_perf.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert port_perf.roofline_pct(0.0, 1.0) is None
    ledger = port_perf.PerfLedger()
    ledger.record("t", "x", rows=1, time_ms=1000.0, kernel_bytes=3.35e11)
    assert ledger.snapshot()["tables"]["t"]["shapes"]["x"]["rooflinePct"]["last"] == 10.0


@pytest.fixture(scope="module")
def segments():
    d = make_data(11, 2000)
    js = jax_build(make_schema(jax_schema), dict(d), "s", table_config=make_config(jax_config))
    ps = port_build(make_schema(port_schema), dict(d), "s", table_config=make_config(port_config))
    return js, ps


def test_analytic_bytes_per_row_matches_jax(segments):
    js, ps = segments
    for cols in (["city"], ["v", "price"], ["year", "day", "tag", "big"], list(ps.columns)):
        for bitmap_params in (0, 2):
            assert port_perf.analytic_bytes_per_row(
                (ps.column(c) for c in cols), bitmap_params=bitmap_params
            ) == jax_perf.analytic_bytes_per_row((js.column(c) for c in cols), bitmap_params=bitmap_params)


@pytest.mark.parametrize("sql", [
    "SELECT SUM(v), COUNT(*) FROM t WHERE year > 2010",
    "SELECT city, AVG(price) FROM t GROUP BY city LIMIT 100",
])
def test_segment_engines_record_the_same_kernel_bytes(segments, sql):
    js, ps = segments
    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(make_schema(jax_schema), make_config(jax_config))
    pe.register_table(make_schema(port_schema), make_config(port_config))
    je.add_segment("t", js)
    pe.add_segment("t", ps)
    want, got = je.query(sql), pe.query(sql)
    assert got.stats.kernel_bytes == want.stats.kernel_bytes > 0
    port_perf.PERF_LEDGER.reset()
    pe.query(sql)
    snap = port_perf.PERF_LEDGER.snapshot()["tables"]["t"]
    assert snap["queries"] == 1 and len(snap["shapes"]) == 1
    port_perf.PERF_LEDGER.reset()
