"""The port's cluster/admission.py against the JAX package's.

Each scenario runs once against each package's module, with the same
inputs, an injected clock where time matters and no wall-clock sleeps,
and records what happens (values, exception types and messages, kill
records, snapshots, METRICS counters): the two records must be equal.
Covered: estimate_query_cost, the token-bucket AdmissionController (shed,
bounded queue with no wait budget, try_charge, deficit, knob-read rate),
ResourceBudget, the QueryWatchdog (runaway, explicit and pressure kills, a
probe from another thread joined with a timeout), the degradation levels
and pipeline_depth_under_pressure, and the ResourceGovernor.  The
distributed engine's pipeline depth follows the autopilot knob and the
pressure cut, as in the JAX engine.
"""
import threading
from types import SimpleNamespace

import pytest

import pinot_tpu  # noqa: F401
from pinot_tpu.cluster import admission as jax_adm
from pinot_tpu.cluster import autopilot as jax_ap
from pinot_tpu.sql.parser import parse_query as jax_parse
from pinot_tpu.utils.metrics import METRICS as JAX_METRICS

from pinot_tpu_torch.cluster import admission as port_adm
from pinot_tpu_torch.cluster import autopilot as port_ap
from pinot_tpu_torch.parallel.engine import DistributedEngine
from pinot_tpu_torch.sql.parser import parse_query as port_parse
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS

from test_torch_dist_engine import _stacked_pair
from torch_port_state import port_state  # noqa: F401

JAX = SimpleNamespace(adm=jax_adm, ap=jax_ap, parse=jax_parse, metrics=JAX_METRICS)
PORT = SimpleNamespace(adm=port_adm, ap=port_ap, parse=port_parse, metrics=PORT_METRICS)


@pytest.fixture(autouse=True)
def _pressure_zero():
    for p in (JAX, PORT):
        p.adm._set_process_pressure(0)
    yield
    for p in (JAX, PORT):
        p.adm._set_process_pressure(0)
        p.ap.reset_knobs()


def both(scenario):
    """Run `scenario(pkg)` for each package; their records must be equal."""
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    return got


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the record compares the failure
        return (type(exc).__name__, str(exc), getattr(exc, "query_id", None))


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def counters(pkg, prefix="admission."):
    return {k: v for k, v in pkg.metrics.snapshot()["counters"].items() if k.startswith(prefix)}


QUERIES = [
    "SELECT COUNT(*) FROM t",
    "SELECT a, SUM(b), COUNT(*) FROM t GROUP BY a",
    "SET numGroupsLimit = 5000; SELECT a, b, MAX(c) FROM t GROUP BY a, b",
    "SELECT a FROM t WHERE b > 3 LIMIT 10",
]
METAS = [
    [],
    [{"numDocs": 1 << 23, "bytes": 48 << 20}, {"numDocs": 1 << 22}],
    [{"numDocs": 5_000_000, "bytes": None}, "not-a-dict", {"numDocs": 0}],
]


@pytest.mark.parametrize("sql", QUERIES)
@pytest.mark.parametrize("metas", range(len(METAS)))
def test_estimate_query_cost(sql, metas):
    def s(p):
        c = p.adm.estimate_query_cost(p.parse(sql), METAS[metas])
        return (c.rows, c.hbm_bytes, c.group_cardinality, c.host_bytes, c.units)

    both(s)


@pytest.mark.parametrize("rate,burst,queue", [(2.0, 4.0, 0), (1.0, None, 2), (0.0, None, 8)])
def test_admission_controller(rate, burst, queue):
    def s(p):
        ctl = p.adm.AdmissionController(rate_units_per_s=rate, burst_units=burst, max_queue=queue,
                                        max_wait_ms=0.0)
        clock = Clock()
        ctl.clock = clock
        rec = []
        for step, (units, prio, dt) in enumerate([(1, 0, 0), (2, 0, 0), (3, 0, 0), (1, -1, 0), (1, 0, 1.5),
                                                   (9, 0, 0), (1, 0, 10), (0.5, -1, 0)]):
            clock.t += dt
            rec.append(outcome(lambda: ctl.admit(f"q{step}", units=units, priority=prio)))
            rec.append((round(ctl.tokens(), 9), round(ctl.deficit(), 9), ctl.try_charge(0.25)))
        rec.append(ctl.snapshot())
        rec.append(counters(p))
        return rec

    both(s)


def test_admission_rate_reads_the_knob(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_ADMISSION_RATE", "4")

    def s(p):
        p.ap.reset_knobs()
        ctl = p.adm.AdmissionController(rate_units_per_s=4.0, burst_units=4.0, max_queue=0, knob="admission_rate")
        clock = Clock()
        ctl.clock = clock
        rec = [ctl.snapshot()["rate"]]
        p.ap.knobs().set("admission_rate", 0.5)
        rec.append(ctl.snapshot()["rate"])
        for _ in range(5):
            rec.append(outcome(lambda: ctl.admit("q", units=1.0)))
        clock.t += 2.0
        rec.append(round(ctl.tokens(), 9))
        return rec

    both(s)


def test_resource_budget():
    def s(p):
        b = p.adm.ResourceBudget(1000, gauge="test.budget")
        rec = [outcome(lambda: b.reserve(600, what="q1", query_id="a"))]
        t1 = rec[0][1]
        rec.append(outcome(lambda: b.reserve(600, what="q2", query_id="b")))
        rec.append((b.try_charge(300), b.try_charge(300), b.in_use, b.peak, b.occupancy()))
        rec.append(b.release(t1))
        b.uncharge(100)
        rec.append((b.in_use, b.peak, b.snapshot()))
        rec.append(outcome(lambda: b.reserve_or_wait(5000, what="huge")))
        rec.append(counters(p))
        return rec

    both(s)


def test_watchdog_kills_and_probe_thread():
    def s(p):
        wd = p.adm.QueryWatchdog(runaway_ms=50.0, pressure_kill_at=0.9)
        clock = Clock()
        wd.clock = clock
        wd.register("a", reserved_bytes=100, priority=0)
        wd.register("b", reserved_bytes=500, priority=0)
        wd.register("c", reserved_bytes=50, priority=-1, runaway_ms=0)
        rec = [wd.kill_reason("a")]
        clock.t += 0.060
        rec.append(wd.kill_reason("a"))
        rec.append(wd.patrol(0.5))
        victim = wd.patrol(0.95)
        rec.append(victim.to_dict() if victim else None)
        rec.append(wd.kill("b", "operator"))
        out = []
        probe = wd.cancel_probe("b")
        th = threading.Thread(target=lambda: out.append(probe()))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        rec.append(out)
        wd.deregister("a")
        rec.append(wd.kill_reason("a"))
        rec.append(wd.snapshot())
        rec.append(counters(p))
        return rec

    both(s)


@pytest.mark.parametrize("floor", [0, 2])
def test_degradation_levels(floor):
    def s(p):
        p.ap.reset_knobs()
        if floor:
            p.ap.knobs().set("degrade_level", floor)
        d = p.adm.DegradationController()
        rec = []
        for occ in (0.0, 0.5, 0.7, 0.84, 0.85, 0.95, 1.2, 0.1):
            lvl = d.update(occ)
            rec.append((lvl, p.adm.current_pressure_level(), d.result_cache_enabled(), d.shed_low_priority(),
                        [d.pipeline_depth(k) for k in (1, 2, 4)]))
        rec.append([p.adm.pipeline_depth_under_pressure(k, lv) for k in (1, 2, 3, 6) for lv in range(4)])
        return rec

    both(s)


def test_resource_governor():
    def s(p):
        budget = p.adm.ResourceBudget(1 << 20, gauge="test.hostBudget")
        gov = p.adm.ResourceGovernor(
            admission=p.adm.AdmissionController(rate_units_per_s=0.0),
            host_budget=budget,
            watchdog=p.adm.QueryWatchdog(),
        )
        rec = []
        grants = []
        for i, sql in enumerate(["SELECT COUNT(*) FROM t",
                                 "SET queryPriority = -1; SELECT COUNT(*) FROM t",
                                 "SET numGroupsLimit = 30000; SELECT a, COUNT(*) FROM t GROUP BY a",
                                 "SET isSecondaryWorkload = true; SELECT COUNT(*) FROM t",
                                 "SET numGroupsLimit = 30000; SELECT a, COUNT(*) FROM t GROUP BY a"]):
            ctx = p.parse(sql)
            cost = p.adm.estimate_query_cost(ctx, [{"numDocs": 1000, "bytes": 4000}])
            r = outcome(lambda: gov.admit(f"q{i}", ctx, cost))
            if r[0] == "ok":
                grants.append(r[1])
                r = ("ok", r[1].query_id)
            rec.append((r, gov.priority_of(ctx), budget.in_use, gov.degrade.level))
        rec.append(gov.snapshot())
        for g in grants:
            g.close()
            g.close()  # idempotent
        rec.append((budget.in_use, gov.snapshot()))
        return rec

    both(s)


def test_pipeline_depth_follows_knob_and_pressure():
    _js, ps = _stacked_pair()
    eng = DistributedEngine(device="cpu")
    eng.register_table("t", ps)
    assert eng.pipeline_depth == 2
    port_ap.knobs().set("pipeline_depth", 1)
    assert eng.pipeline_depth == 1
    eng.pipeline_depth = 3
    port_ap.knobs().set("pipeline_depth", 2)
    assert eng.pipeline_depth == 3  # an assignment pins
    assert DistributedEngine(device="cpu", pipeline_depth=4).pipeline_depth == 4

    # the pressure cut: level 2 drops one in-flight launch, level 3 serialises
    seen = []
    real = port_adm.pipeline_depth_under_pressure

    def spy(depth, level=None):
        out = real(depth, level)
        seen.append((depth, level, out))
        return out

    import pinot_tpu_torch.parallel.engine as eng_mod

    eng_mod.pipeline_depth_under_pressure = spy
    try:
        sql = "SET trace = true; SELECT d, SUM(rev) FROM t GROUP BY d LIMIT 5"
        r0 = eng.query(sql)
        assert seen == []
        port_adm._set_process_pressure(2)
        r2 = eng.query(sql)
        port_adm._set_process_pressure(3)
        eng.query(sql)
    finally:
        eng_mod.pipeline_depth_under_pressure = real
    assert seen == [(3, 2, 2), (3, 3, 1)]
    assert r2.rows == r0.rows
    run = [c for c in r2.stats.trace["children"] if c["name"] == "run"][0]
    assert run["attrs"]["pressure"] == 2
