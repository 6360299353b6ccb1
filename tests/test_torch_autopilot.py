"""The port's cluster/autopilot.py against the JAX package's.

Each scenario runs once against each package with the same inputs (a fake
clock and a fake perf ledger for the controller, no thread and no sleep)
and the records must be equal: knob reads and clamped writes, env
defaults, snapshots, the controller's decisions tick by tick (breach,
degrade down the ladder, cooldown, recover, the oscillation cap, idle and
disabled), the residency splits it publishes by traffic share, and the
sensing backoff.  The three readers of the knobs in the port follow them:
the distributed engine's pipeline depth, the server's staging depth and the
residency manager's split-aware eviction (which evicts the most over-share
table first, as the JAX manager does).
"""
import pytest

import pinot_tpu  # noqa: F401
from pinot_tpu.cluster import admission as jax_adm
from pinot_tpu.cluster import autopilot as jax_ap
from pinot_tpu.segment import residency as jax_res

from pinot_tpu_torch.cluster import admission as port_adm
from pinot_tpu_torch.cluster import autopilot as port_ap
from pinot_tpu_torch.cluster import server as port_server
from pinot_tpu_torch.segment import residency as port_res

from torch_port_state import port_state  # noqa: F401

PKGS = {"jax": (jax_ap, jax_adm, jax_res), "port": (port_ap, port_adm, port_res)}


@pytest.fixture(autouse=True)
def _knobs():
    jax_ap.reset_knobs()
    port_ap.reset_knobs()
    yield
    jax_ap.reset_knobs()
    port_ap.reset_knobs()


def both(scenario):
    want = scenario(*PKGS["jax"])
    got = scenario(*PKGS["port"])
    assert got == want
    return got


class FakeLedger:
    def __init__(self):
        self.tables = {}

    def snapshot(self):
        return {"tables": {t: {"qps": q, "shapes": {"s": {"latencyMs": {"p99": p, "max": p}}}}
                           for t, (p, q) in self.tables.items()}}


def test_registry_reads_writes_and_snapshot(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_PIPELINE_DEPTH", "4")
    monkeypatch.setenv("PINOT_TPU_BATCH_WAIT_MS", "3")

    def s(ap, _adm, _res):
        reg = ap.KnobRegistry()
        rec = [reg.view(), {n: reg.bounds(n) for n in reg.names()}]
        rec.append(reg.set("pipeline_depth", 9))
        rec.append(reg.set("pipeline_depth", 2.6))
        rec.append(reg.set_many({"batch_wait_ms": -5, "degrade_level": 7, "staging_depth": 1}))
        rec.append(reg.view())
        reg.set_splits({"a": 0.75, "b": -1})
        rec.append((reg.splits(), reg.snapshot()))
        reg.reset()
        rec.append((reg.view(), reg.splits()))
        rec.append(ap.autopilot_enabled())
        return rec

    both(s)


def _drive(ap, slo, script):
    sim = [0.0]
    reg = ap.KnobRegistry()
    led = FakeLedger()
    pilot = ap.Autopilot(registry=reg, ledger=led, clock=lambda: sim[0], tick_s=1.0, slo_ms=slo)
    out = []
    for p99, n in script:
        for _ in range(n):
            if p99 is None:
                led.tables.pop("t", None)
            else:
                led.tables["t"] = (p99, 10.0)
            sim[0] += 1.0
            d = pilot.tick()
            out.append({k: v for k, v in d.items() if k != "signal"})
    snap = pilot.snapshot()
    snap.pop("decisions")
    return out, reg.view(), snap


@pytest.mark.parametrize("slo,script", [
    (100.0, [(400.0, 4), (20.0, 60)]),
    (100.0, [(400.0, 48)]),
    (100.0, [(None, 3), (80.0, 3), (400.0, 1), (20.0, 1), (400.0, 1)]),
    (0.0, [(400.0, 2)]),
], ids=["degrade_recover", "oscillation_cap", "idle_band_reset", "disabled"])
def test_controller_decisions(slo, script):
    both(lambda ap, _a, _r: _drive(ap, slo, script))


def test_controller_walks_the_whole_ladder(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_ADMISSION_RATE", "8")
    monkeypatch.setenv("PINOT_TPU_PIPELINE_DEPTH", "4")
    both(lambda ap, _a, _r: _drive(ap, 50.0, [(500.0, 120), (10.0, 200)]))


def test_splits_follow_traffic_share():
    def s(ap, _a, _r):
        reg = ap.KnobRegistry()
        led = FakeLedger()
        pilot = ap.Autopilot(registry=reg, ledger=led, clock=lambda: 0.0, tick_s=1.0, slo_ms=100.0)
        led.tables = {"hot": (50.0, 30.0), "cold": (50.0, 10.0)}
        pilot.tick()
        one = reg.splits()
        led.tables = {"hot": (50.0, 30.0)}
        pilot.tick()
        return one, reg.splits()

    got = both(s)
    assert got[0] == {"hot": 0.75, "cold": 0.25}


@pytest.mark.parametrize("action", ["hold", "idle", "saturated", "degrade", "cooldown", "breach-pending"])
def test_sensing_backoff(action):
    both(lambda ap, _a, _r: [ap.Autopilot._next_backoff(b, action) for b in (1, 2, 4, 8)])


def test_governor_signal_and_telemetry_failure():
    class Broken:
        def snapshot(self):
            raise RuntimeError("ledger down")

    def s(ap, adm, _r):
        gov = adm.ResourceGovernor(host_budget=adm.ResourceBudget(1000))
        pilot = ap.Autopilot(registry=ap.KnobRegistry(), ledger=Broken(), governor=gov,
                             clock=lambda: 0.0, tick_s=1.0, slo_ms=100.0)
        d = pilot.tick()
        return d["action"], {k: d["signal"][k] for k in ("p99_ms", "qps", "hostPeakBytes", "occupancy")}

    both(s)


def test_readers_follow_the_knobs():
    from pinot_tpu_torch.parallel.engine import DistributedEngine

    eng = DistributedEngine(device="cpu", hbm_cache_bytes=0)
    assert eng.pipeline_depth == 2 and port_server._staging_depth() == 2
    port_ap.knobs().set("pipeline_depth", 1)
    port_ap.knobs().set("staging_depth", 1)
    assert eng.pipeline_depth == 1 and port_server._staging_depth() == 1
    dc = port_adm.DegradationController()
    port_ap.knobs().set("degrade_level", 2)
    assert dc.update(0.0) == 2


def test_residency_eviction_follows_the_splits():
    """Two tables resident; the budget is full; the over-share table
    donates first once splits are published, whatever the recency."""

    def s(ap, adm, res):
        rec = []
        for splits in ({}, {"A": 0.2, "B": 0.8}, {"A": 0.9, "B": 0.1}):
            ap.reset_knobs()
            if splits:
                ap.knobs().set_splits(splits)
            mgr = res.ResidencyManager(adm.ResourceBudget(1000), name="res.split")
            evicted = []
            groups = [(("a", 1), "A"), (("b", 1), "B"), (("a", 2), "A")]
            for g, t in groups:
                mgr.begin_stage(g, t, lambda g=g: evicted.append(g))
                mgr.charge(g, 300)
                mgr.finish_stage(g)
            mgr.touch(("a", 1))
            g = ("c", 1)
            mgr.begin_stage(g, "C", lambda: evicted.append(g))
            mgr.charge(g, 300)
            mgr.finish_stage(g)
            rec.append(evicted)
        return rec

    got = both(s)
    assert got[1] == [("a", 2)] and got[2] == [("b", 1)]
