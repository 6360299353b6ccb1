"""Tiered residency of the port (segment/residency.py and its callers),
held to the JAX package's tests/test_residency.py and against the JAX
package's tiered engine.

Device memory is a byte-budgeted cache over host RAM.  These tests drive the
residency state machine (host-only -> staging -> resident -> evicting)
under concurrency, kill a stage mid-flight at both crash points for an
ImmutableSegment and a StackedTable and assert the budget never leaks,
race readers against evictions so that a group's raw and #packed flavours
drop atomically, pin the staged-fetch admission semantics, and run the
distributed engine's staging pipeline on the CPU at about 1/3 of its
working set: rows identical to the untiered port engine and to the JAX
tiered engine (assert_rows_match: exact), evicting, exact under a racing
evictor, one prefetch hit or stall per streamed batch, and a failure on the
staging thread raised in the query with no bytes left charged.
"""
import itertools
import threading
import time

import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.cluster.admission import ReservationError, ResourceBudget
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.segment import residency as res_mod
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.residency import (
    HIT,
    HOST_ONLY,
    OWN,
    RESIDENT,
    STAGING,
    WAIT,
    ResidencyManager,
)
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.utils import crashpoints
from pinot_tpu_torch.utils.metrics import METRICS
from pinot_tpu_torch.utils.perf import PERF_LEDGER, PerfLedger

from test_torch_query import assert_rows_match

_seq = itertools.count()


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """The port's METRICS registry and perf ledger are process-global."""
    METRICS.reset()
    PERF_LEDGER.reset()
    yield


def _mgr(budget_bytes, ledger=None):
    """Fresh manager with a unique metrics namespace (global registry)."""
    return ResidencyManager(ResourceBudget(budget_bytes), name=f"res.t{next(_seq)}", ledger=ledger)


def _schema(S, name):
    return S.Schema(name, [S.FieldSpec("g", S.DataType.INT), S.FieldSpec("v", S.DataType.INT, role=S.FieldRole.METRIC)])


def _gv_data(n):
    rng = np.random.default_rng(3)
    return {"g": rng.integers(0, 16, n).astype(np.int32), "v": rng.integers(0, 100, n).astype(np.int32)}


def _segment(name="segres", n=4096):
    return build_segment(_schema(port_schema, name), _gv_data(n), "s0")


def _stacked(name="stackres", n=4096):
    return PortStacked.build(_schema(port_schema, name), _gv_data(n), num_shards=1)


def _group(table):
    """The residency group of a segment, or of a stacked table's whole-table
    doc slice, on the CPU."""
    if isinstance(table, PortStacked):
        return table.device_group("cpu", (0, table.docs_per_shard))
    return table.device_group("cpu")


def _stage(table, res, columns=None, packed=False):
    """to_device with a residency manager on the CPU, for a segment or a
    stacked table (one whole-table doc slice, without the valid mask, as
    the distributed engine stages it), and the group it charges."""
    if isinstance(table, PortStacked):
        cols, _ = table.to_device("cpu", columns, with_valid=False, packed_codes=packed, residency=res)
    else:
        cols = table.to_device("cpu", columns, packed_codes=packed, residency=res)
    return cols, _group(table)


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------
class TestStateMachine:
    def test_own_stage_commit_hit_evict(self):
        res = _mgr(1_000)
        evicted = []
        g = ("seg", 1, None)
        st, _ = res.begin_stage(g, "t", lambda: evicted.append(g))
        assert st == OWN and res.state_of(g) == STAGING
        res.charge(g, 400)
        res.finish_stage(g)
        assert res.state_of(g) == RESIDENT
        assert res.resident_bytes == 400 == res.budget.in_use
        st2, _ = res.begin_stage(g, "t", lambda: None)
        assert st2 == HIT
        assert res.evict(g)
        assert evicted == [g]
        assert res.state_of(g) == HOST_ONLY
        assert res.resident_bytes == 0 == res.budget.in_use

    def test_waiters_park_then_hit_after_commit(self):
        res = _mgr(1_000)
        g = ("seg", 2, None)
        st, _ = res.begin_stage(g, "t", lambda: None)
        assert st == OWN
        statuses = []

        def waiter():
            s, entry = res.begin_stage(g, "t", lambda: None)
            statuses.append(s)
            if s == WAIT:
                assert res.wait(entry, timeout_s=5.0)

        threads = [threading.Thread(target=waiter) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while len(statuses) < 4 and time.monotonic() < deadline:  # every waiter met the STAGING entry
            time.sleep(0.001)
        res.charge(g, 100)
        res.finish_stage(g)
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert statuses == [WAIT] * 4
        assert res.state_of(g) == RESIDENT

    def test_abort_of_fresh_stage_removes_entry_and_uncharges(self):
        res = _mgr(1_000)
        g = ("seg", 3, None)
        res.begin_stage(g, "t", lambda: None)
        res.charge(g, 300)
        assert res.budget.in_use == 300
        res.abort_stage(g)
        assert res.state_of(g) == HOST_ONLY
        assert res.budget.in_use == 0 and res.resident_bytes == 0

    def test_abort_of_grow_reverts_to_resident(self):
        res = _mgr(1_000)
        g = ("seg", 4, None)
        res.begin_stage(g, "t", lambda: None)
        res.charge(g, 200)
        res.finish_stage(g)
        st, _ = res.begin_grow(g)
        assert st == OWN and res.state_of(g) == STAGING
        res.charge(g, 150)
        res.abort_stage(g)
        # the committed 200 bytes survive; only the grow's 150 unwind
        assert res.state_of(g) == RESIDENT
        assert res.resident_bytes == 200 == res.budget.in_use


# ---------------------------------------------------------------------------
# cost-aware eviction
# ---------------------------------------------------------------------------
class TestCostRankedEviction:
    def test_cold_table_evicted_before_hot_despite_recency(self):
        ledger = PerfLedger()
        # hot table: high bytes/s in the ledger -> expensive to refetch
        ledger.record("hotT", "fp", rows=1e6, time_ms=10.0, kernel_bytes=1e9)
        res = _mgr(1_000, ledger=ledger)
        evicted = []
        a, b, c = ("a", None), ("b", None), ("c", None)
        res.begin_stage(a, "coldT", lambda: evicted.append("a"))
        res.charge(a, 400)
        res.finish_stage(a)
        res.begin_stage(b, "hotT", lambda: evicted.append("b"))
        res.charge(b, 400)
        res.finish_stage(b)
        res.touch(a)  # pure LRU would now pick b; the heat signal must win
        res.begin_stage(c, "t3", lambda: evicted.append("c"))
        res.charge(c, 400)
        res.finish_stage(c)
        assert evicted == ["a"]
        assert res.state_of(a) == HOST_ONLY and res.state_of(b) == RESIDENT

    def test_lru_fallback_without_ledger_signal(self):
        res = _mgr(1_000)
        evicted = []
        a, b, c = ("a", None), ("b", None), ("c", None)
        for g, nm in ((a, "a"), (b, "b")):
            res.begin_stage(g, "t", lambda nm=nm: evicted.append(nm))
            res.charge(g, 400)
            res.finish_stage(g)
        res.touch(a)  # b is now least-recent
        res.begin_stage(c, "t", lambda: evicted.append("c"))
        res.charge(c, 400)
        res.finish_stage(c)
        assert evicted == ["b"]

    def test_unfittable_charge_raises_and_unwinds(self):
        res = _mgr(100)
        g = ("seg", 9, None)
        res.begin_stage(g, "t", lambda: None)
        with pytest.raises(ReservationError):
            res.charge(g, 200)
        res.abort_stage(g)
        assert res.state_of(g) == HOST_ONLY
        assert res.budget.in_use == 0 and res.resident_bytes == 0

    def test_engine_queries_feed_the_heat(self):
        """Both engines record every query in the process ledger, which the
        default manager reads as heat."""
        pe = PortDist(device="cpu", hbm_cache_bytes=1 << 20)
        pe.register_table("hot", _stacked("hot"))
        pe.query("SELECT SUM(v) FROM hot")
        heat = pe.residency._table_heat({"hot", "cold"})
        assert heat["hot"] > 0 and "cold" not in heat


# ---------------------------------------------------------------------------
# mid-stage kill: no budget leak
# ---------------------------------------------------------------------------
@pytest.fixture
def _clean_points():
    crashpoints.reset()
    yield
    crashpoints.reset()


class TestMidStageCrash:
    @pytest.mark.parametrize("point", ["segment.stage.after_charge", "segment.stage.after_copy"])
    @pytest.mark.parametrize("make", [_segment, _stacked], ids=["segment", "stacked"])
    def test_killed_stage_leaves_no_ledger_leak_and_retries_clean(self, point, make, _clean_points):
        table = make()
        res = _mgr(10 << 20)
        crashpoints.arm(point)
        with pytest.raises(crashpoints.InjectedCrash):
            _stage(table, res)
        assert res.state_of(_group(table)) == HOST_ONLY
        assert res.budget.in_use == 0 and res.resident_bytes == 0
        # the point disarmed on firing: the post-restart retry commits
        cols, group = _stage(table, res)
        assert set(cols) == {"g", "v"}
        assert res.state_of(group) == RESIDENT
        assert res.budget.in_use == res.resident_bytes > 0

    @pytest.mark.parametrize("make", [_segment, _stacked], ids=["segment", "stacked"])
    def test_killed_grow_keeps_committed_bytes(self, make, _clean_points):
        table = make()
        res = _mgr(10 << 20)
        _, group = _stage(table, res, columns=["g"])
        committed = res.resident_bytes
        assert committed > 0
        crashpoints.arm("segment.stage.after_copy")
        with pytest.raises(crashpoints.InjectedCrash):
            _stage(table, res, columns=["g", "v"])
        assert res.state_of(group) == RESIDENT
        assert res.budget.in_use == res.resident_bytes == committed
        cols, _ = _stage(table, res, columns=["g", "v"])
        assert set(cols) == {"g", "v"}
        assert res.budget.in_use == res.resident_bytes > committed


# ---------------------------------------------------------------------------
# atomic flavour eviction: a reader never mixes tiers
# ---------------------------------------------------------------------------
class TestAtomicFlavorEviction:
    @pytest.mark.parametrize("make", [_segment, _stacked], ids=["segment", "stacked"])
    def test_concurrent_readers_race_eviction_without_mixing(self, make):
        """Readers alternate raw and #packed requests while an evictor drops
        the group; every assembled entry set must be complete for the
        requested flavour (assemble returns None on a half-evicted cache and
        the reader re-stages)."""
        table = make(n=8192)
        res = _mgr(10 << 20)
        stop = threading.Event()
        errors = []
        group = _group(table)

        def reader(packed):
            try:
                for _ in range(30):
                    cols, _ = _stage(table, res, packed=packed)
                    if set(cols) != {"g", "v"}:
                        errors.append(f"partial entries: {sorted(cols)}")
                    key = "codes_packed" if packed else "codes"
                    if key not in cols["g"]:
                        errors.append(f"mixed flavours: {sorted(cols['g'])}")
            except Exception as exc:  # pragma: no cover - failure detail
                errors.append(repr(exc))

        def evictor():
            while not stop.is_set():
                res.evict(group)
                time.sleep(0.001)

        threads = [threading.Thread(target=reader, args=(p,)) for p in (False, True)]
        ev = threading.Thread(target=evictor)
        ev.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        stop.set()
        ev.join(timeout=10)
        assert errors == []
        # the ledger is exact after the dust settles: committed == charged
        assert res.budget.in_use == res.resident_bytes

    @pytest.mark.parametrize("make", [_segment, _stacked], ids=["segment", "stacked"])
    def test_eviction_between_hit_and_read_restages(self, make, monkeypatch):
        """The window the race above hits by chance, hit on purpose: the
        group is evicted after begin_stage answered HIT and before the
        entries are read.  The read must see the gap and stage again, not
        return the half (here: none) of the group that is left."""
        table = make()
        res = _mgr(10 << 20)
        _stage(table, res)
        real = res.begin_stage
        fired = []

        def hit_then_evict(group, *args, **kwargs):
            st, entry = real(group, *args, **kwargs)
            if st == HIT and not fired:
                fired.append(group)
                assert res.evict(group)
            return st, entry

        monkeypatch.setattr(res, "begin_stage", hit_then_evict)
        cols, group = _stage(table, res)
        assert fired == [group]
        assert set(cols) == {"g", "v"} and "codes" in cols["g"] and "values" in cols["v"]
        assert res.state_of(group) == RESIDENT
        assert res.budget.in_use == res.resident_bytes > 0

    @pytest.mark.parametrize("make", [_segment, _stacked], ids=["segment", "stacked"])
    def test_single_owner_stages_group_once(self, make):
        table = make()
        res = _mgr(10 << 20)
        barrier = threading.Barrier(6)
        outs = []
        lock = threading.Lock()

        def worker():
            barrier.wait()
            cols, _ = _stage(table, res)
            with lock:
                outs.append(set(cols))

        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert outs == [{"g", "v"}] * 6
        # one miss -> one staging owner; everyone else waited or hit
        assert METRICS.counter(f"{res.name}.misses").value == 1


# ---------------------------------------------------------------------------
# staged-fetch admission (reserve_or_wait)
# ---------------------------------------------------------------------------
class TestStagedFetchAdmission:
    def test_rejects_immediately_when_unfittable_even_transiently(self):
        b = ResourceBudget(100)
        with pytest.raises(ReservationError, match="even\\s+transiently"):
            b.reserve_or_wait(150, max_wait_ms=5_000)

    def test_parks_until_release_then_admits(self):
        b = ResourceBudget(100)
        t = b.reserve(80)

        def releaser():
            time.sleep(0.05)
            b.release(t)

        th = threading.Thread(target=releaser)
        th.start()
        ticket = b.reserve_or_wait(50, max_wait_ms=5_000)
        th.join(timeout=10)
        assert b.in_use == 50 and b.peak == 80
        assert METRICS.counter("admission.stagedFetchServed").value == 1
        b.release(ticket)

    def test_times_out_to_out_of_capacity(self):
        b = ResourceBudget(100)
        b.reserve(80)
        with pytest.raises(ReservationError, match="staged wait"):
            b.reserve_or_wait(50, max_wait_ms=40)
        assert METRICS.counter("admission.stagedFetchTimeouts").value == 1


# ---------------------------------------------------------------------------
# the distributed engine's staging pipeline at about 1/3 of its working set
# ---------------------------------------------------------------------------
N = 64 * 1024  # 6 B a doc: launch_bytes=8000 splits the doc axis into 50 launches
LAUNCH_BYTES = 8_000
BATCHES = 50
CACHE_BYTES = 128_000  # about 1/3 of the ~390 kB working set

QUERIES = [
    "SELECT COUNT(*), SUM(v), MIN(v), MAX(v) FROM t",
    "SELECT COUNT(*), SUM(v) FROM t WHERE d < 32",
    "SELECT d, COUNT(*), SUM(v) FROM t GROUP BY d ORDER BY d LIMIT 70",
    "SELECT d, SUM(v) FROM t WHERE q < 25 GROUP BY d LIMIT 100",
    "SELECT q, MIN(v), MAX(v) FROM t WHERE q < 25 GROUP BY q ORDER BY q LIMIT 100",
]


def _tiered_schema(S):
    return S.Schema("t", [
        S.FieldSpec("d", S.DataType.INT),
        S.FieldSpec("q", S.DataType.INT),
        S.FieldSpec("v", S.DataType.INT, role=S.FieldRole.METRIC),
    ])


def _tiered_config(C):
    return C.TableConfig("t", indexing=C.IndexingConfig(range_index_columns=["q"]))


def _tiered_data():
    rng = np.random.default_rng(5)
    return {
        "d": rng.integers(0, 64, N).astype(np.int32),
        "q": rng.integers(1, 51, N).astype(np.int32),
        "v": rng.integers(-50, 50, N).astype(np.int32),
    }


def _port_engine(data, cache_bytes):
    e = PortDist(device="cpu", launch_bytes=LAUNCH_BYTES, hbm_cache_bytes=cache_bytes)
    e.register_table("t", PortStacked.build(_tiered_schema(port_schema), dict(data), 1,
                                            table_config=_tiered_config(port_config)))
    return e


@pytest.fixture(scope="module")
def tiered():
    """(tiered port engine, untiered port engine, JAX tiered engine)."""
    data = _tiered_data()
    je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=LAUNCH_BYTES, hbm_cache_bytes=CACHE_BYTES)
    je.register_table("t", JaxStacked.build(_tiered_schema(jax_schema), dict(data), 1,
                                            table_config=_tiered_config(jax_config)))
    tiered_port, untiered = _port_engine(data, CACHE_BYTES), _port_engine(data, 0)
    yield tiered_port, untiered, je
    tiered_port.residency.shutdown()
    je.residency.shutdown()


class TestTieredEngine:
    def test_plans_stream_many_batches(self, tiered):
        from pinot_tpu_torch.sql.parser import parse_query

        tiered_port, untiered, _ = tiered
        assert untiered.residency is None
        for q in QUERIES:
            assert len(tiered_port._plan(parse_query(q), tiered_port.tables["t"]).batch_offsets) == BATCHES

    @pytest.mark.parametrize("sql", QUERIES)
    def test_over_budget_working_set_matches_untiered_and_jax(self, tiered, sql):
        tiered_port, untiered, je = tiered
        ev0 = METRICS.counter("residency.evictions").value
        got = tiered_port.query(sql)
        assert_rows_match(got.rows, untiered.query(sql).rows, ordered=True)
        assert_rows_match(got.rows, je.query(sql).rows, ordered="ORDER BY" in sql)
        assert METRICS.counter("residency.evictions").value > ev0
        res = tiered_port.residency
        assert res.budget.peak <= CACHE_BYTES
        assert res.budget.in_use == res.resident_bytes <= CACHE_BYTES

    def test_queries_racing_manager_evictions_stay_exact(self, tiered):
        tiered_port, untiered, _ = tiered
        for q in (QUERIES[2], QUERIES[3]):
            expect = untiered.query(q).rows
            stop = threading.Event()

            def evictor():
                while not stop.is_set():
                    tiered_port.residency.evict_matching(lambda g: True)
                    time.sleep(0.002)

            th = threading.Thread(target=evictor)
            th.start()
            try:
                for _ in range(6):
                    assert tiered_port.query(q).rows == expect
            finally:
                stop.set()
                th.join(timeout=10)
            assert not th.is_alive()

    @pytest.mark.parametrize("sql", [QUERIES[1], QUERIES[3]])
    def test_prefetch_hits_plus_stalls_equal_streamed_batches(self, tiered, sql):
        """Every streamed macro-batch is consumed exactly once, as either a
        prefetch hit or a staging stall."""
        tiered_port, _, _ = tiered
        for _ in range(2):
            h0 = METRICS.counter("engine.prefetchHits").value
            s0 = METRICS.counter("engine.stagingStalls").value
            tiered_port.query(sql)
            hits = METRICS.counter("engine.prefetchHits").value - h0
            stalls = METRICS.counter("engine.stagingStalls").value - s0
            assert hits + stalls == BATCHES
        assert METRICS.histogram("residency.stagingStallMs").count >= stalls

    def test_dist_metrics_and_ledger(self, tiered):
        tiered_port, _, _ = tiered
        q0 = METRICS.counter("dist.queries").value
        res = tiered_port.query(QUERIES[0])
        assert METRICS.counter("dist.queries").value == q0 + 1
        assert METRICS.histogram("dist.queryLatency").count >= 1
        # v (4 B) over the 50 launches of 1,312 docs: the analytic byte model
        assert res.stats.kernel_bytes == BATCHES * 1312 * 4.0
        snap = PERF_LEDGER.snapshot()["tables"]["t"]
        assert snap["queries"] >= 1

    @pytest.mark.parametrize("point", ["segment.stage.after_charge", "segment.stage.after_copy"])
    def test_crash_on_the_staging_thread_raises_in_the_query(self, point, _clean_points):
        data = _tiered_data()
        e = _port_engine(data, CACHE_BYTES)
        try:
            crashpoints.arm(point, hit=3)  # a prefetched batch's stage
            with pytest.raises(crashpoints.InjectedCrash):
                e.query(QUERIES[0])
            res = e.residency
            # the failed stage unwound its charge; what stayed is resident
            assert res.budget.in_use == res.resident_bytes
            assert res.snapshot()["byState"].get(res_mod.STAGING, 0) == 0
            # the point disarmed on firing: the query runs again, exact
            assert e.query(QUERIES[0]).rows == _port_engine(data, 0).query(QUERIES[0]).rows
        finally:
            e.residency.shutdown()

    def test_failing_copy_leaves_no_charged_bytes(self, monkeypatch):
        """A copy that fails on the staging thread (a device error) every
        time: the query raises it and the budget is back at 0."""
        e = _port_engine(_tiered_data(), CACHE_BYTES)
        stacked = e.tables["t"]

        def failing(*args, **kwargs):
            raise RuntimeError("copy failed")

        monkeypatch.setattr(stacked, "_stage_slice", failing)
        try:
            with pytest.raises(RuntimeError, match="copy failed"):
                e.query(QUERIES[1])
            assert e.residency.budget.in_use == 0 and e.residency.resident_bytes == 0
            assert e.residency.snapshot()["groups"] == 0
        finally:
            e.residency.shutdown()

    def test_default_residency_reads_the_environment(self, monkeypatch):
        monkeypatch.setenv("PINOT_TPU_HBM_CACHE_BYTES", "0")
        assert PortDist(device="cpu").residency is None
        monkeypatch.setenv("PINOT_TPU_HBM_CACHE_BYTES", str(1 << 20))
        assert PortDist(device="cpu").residency.budget.budget_bytes == 1 << 20
        monkeypatch.delenv("PINOT_TPU_HBM_CACHE_BYTES")
        assert PortDist(device="cpu").residency.budget.budget_bytes == 8 << 30


def test_row_residency_splits_the_budget():
    mgrs = [res_mod.row_residency(4, r, total_bytes=1 << 20) for r in range(4)]
    assert [m.budget.budget_bytes for m in mgrs] == [1 << 18] * 4
    assert [m.name for m in mgrs] == [f"residency.row{r}" for r in range(4)]
    assert res_mod.row_residency(4, 0, total_bytes=0) is None
