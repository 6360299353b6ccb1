"""Deterministic fault injection for the cluster layer.

Copy of pinot_tpu/cluster/faults.py (host-only).  In the port the server
(cluster/server.py) consults it; the coordinator, the journal and the
election hooks below attach once those modules are ported (ROADMAP.md).

Reference parity: Pinot exercises its failover paths with integration tests
that kill servers mid-query (e.g. OfflineGRPCServerIntegrationTest /
ServerStarter restarts); here the same chaos is scripted as data.  A
FaultPlan is a seeded, reproducible schedule of faults keyed by (server,
call number): fail server S on its Nth scatter call, add fixed latency,
drop a segment from its local view, flap coordinator liveness, CRASH a
server (process death: its segment state is lost and recovery is a full
coordinator-driven restart + deep-store reconcile) or restart a crashed
one mid-workload.  Hooks live in ServerInstance.execute (on_execute /
segment_dropped) and the coordinator (mark_down / mark_up / crash_server /
restart_server), so every failover/quarantine/partial-result path in the
broker is driven by tier-1 tests instead of hoped-for.  Orthogonally,
kill_at() arms named kill-points (utils/crashpoints.py) sitting between
the write/rename/swap steps of every commit path — segment seal, journal
append, snapshot compaction, deep-store upload/download, rebalance move —
so crash-recovery tests can die at EXACTLY one protocol step and assert
the restart converges to committed state.

Gray failures get first-class rules too: jitter() draws seeded lognormal
per-call delays (keyed on (seed, server, call) so thread interleaving can't
change the sequence), slow_ramp() degrades latency linearly toward a cap,
gray_flap() alternates slow/fast phases, and partition(src, dst) drops
src->dst calls one-way while dst->src keeps working.  All delays go through
the injectable `plan.sleep`, so tier-1 tests swap in a fake clock and never
block.

The CONTROL-PLANE fault family for coordinator HA
(cluster/election.py): pause_leader() freezes a coordinator (every
control-plane entry point refuses, lease renewals silently stop — the GC
pause that outlives lease expiry), resume_leader() thaws it into the epoch
fence, lease_clock_skew() offsets one node's view of cluster time, and
journal_append_latency() delays durable appends (fsync stall).  Hooks live
in LeaseManager.now/renew and MetaJournal.append via attach_coordinator().

Determinism contract: the same plan (same seed, same builder calls) applied
to an identically-built cluster produces the same fault sequence, hence the
same BrokerResponse — asserted by tests/test_fault_tolerance.py.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple


class ServerFaultError(RuntimeError):
    """Injected server-side failure — the harness' stand-in for a crashed or
    unreachable server (the broker must treat it like any transport error)."""


@dataclass
class _Rule:
    kind: str  # "fail" | "latency" | "jitter" | "slow_ramp" | "gray_flap" | "partition" | "flap_down" | "flap_up" | "crash" | "restart"
    trigger: str  # server whose call counter drives the rule
    target: str  # server the effect applies to (== trigger for fail/latency)
    calls: Optional[Set[int]] = None  # 1-based call numbers; None = every call
    ms: float = 0.0
    message: str = ""
    sigma: float = 0.0  # lognormal shape for "jitter"
    cap_ms: float = 0.0  # latency ceiling for "jitter"/"slow_ramp" (0 = none)
    period: int = 0  # phase length in calls for "gray_flap"
    source: Optional[str] = None  # caller that the "partition" rule drops
    start_call: int = 1  # first call a "slow_ramp" counts from


# fail/crash raise (crash of the trigger itself), so side-effecting rules on
# the same call apply first; restarts precede crashes so a restart+crash pair
# scheduled on one call nets out to "bounced then died" deterministically
_APPLY_ORDER = {
    "latency": 0,
    "jitter": 0,
    "slow_ramp": 0,
    "gray_flap": 0,
    "restart": 1,
    "flap_down": 2,
    "flap_up": 2,
    "crash": 3,
    "partition": 4,
    "fail": 4,
}


class FaultPlan:
    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.sleep = time.sleep  # injectable for clock-free tests
        self.log: List[Tuple] = []  # (server, call_n, kind, detail) as applied
        self._rules: List[_Rule] = []
        self._dropped: Set[Tuple[str, str, str]] = set()  # (server, table, segment)
        self._calls: Dict[str, int] = {}
        self._coordinator = None
        self._lock = threading.Lock()
        self._kill_points: List[str] = []  # armed via kill_at, for reset
        # control-plane fault state (coordinator HA): paused leader node
        # ids, per-node lease clock skew, per-node journal append latency,
        # and the coordinators wired via attach_coordinator (keyed by
        # node_id — one entry per cluster coordinator)
        self._paused_leaders: Set[str] = set()
        self._lease_skew_ms: Dict[str, float] = {}
        self._journal_latency_ms: Dict[str, float] = {}
        self._journal_appends: Dict[str, int] = {}
        self._coordinators: Dict[str, object] = {}

    # -- wiring ----------------------------------------------------------
    def attach(self, coordinator) -> "FaultPlan":
        """Install the plan into every registered server + the coordinator
        (servers registered later can be given `server.fault_plan = plan`)."""
        self._coordinator = coordinator
        for s in coordinator.servers.values():
            s.fault_plan = self
        self.attach_coordinator(coordinator)
        return self

    def attach_coordinator(self, coordinator) -> "FaultPlan":
        """Wire the control-plane fault hooks (lease skew, renew
        suppression, journal append latency) into one coordinator — call it
        for the leader AND each standby; attach() covers the leader."""
        self._coordinators[getattr(coordinator, "node_id", "coordinator")] = coordinator
        coordinator.fault_plan = self
        election = getattr(coordinator, "election", None)
        if election is not None:
            election.fault_plan = self
        journal = getattr(coordinator, "journal", None)
        if journal is not None:
            journal.fault_plan = self
        return self

    # -- plan builders (chainable) ----------------------------------------
    def fail_server(self, server: str, on_call: int = 1, times: int = 1, message: str = "") -> "FaultPlan":
        """Raise ServerFaultError on the server's Nth..N+times-1th execute."""
        # test-harness plan builder, not a serving path: rules are bounded by
        # the test script that authors them
        self._rules.append(
            _Rule("fail", server, server, calls=set(range(on_call, on_call + times)), message=message)
        )
        return self

    def always_fail(self, server: str, message: str = "") -> "FaultPlan":
        self._rules.append(_Rule("fail", server, server, calls=None, message=message))
        return self

    def add_latency(self, server: str, ms: float, on_call: Optional[int] = None) -> "FaultPlan":
        """Sleep `ms` at the top of the server's execute (every call when
        on_call is None) — the slow-replica / network-delay fault."""
        calls = None if on_call is None else {on_call}
        self._rules.append(_Rule("latency", server, server, calls=calls, ms=ms))
        return self

    def jitter(self, server: str, base_ms: float, sigma: float = 0.5, cap_ms: float = 0.0) -> "FaultPlan":
        """Seeded lognormal latency jitter on every call: the per-call delay is
        ``base_ms * lognormvariate(0, sigma)`` drawn from a generator keyed on
        (plan seed, server, call number), so the sequence is bit-identical
        across runs AND independent of thread interleaving — call N always
        draws the same delay no matter which worker reaches it first."""
        # plan builder (test-authored, bounded), not a serving path
        self._rules.append(
            _Rule("jitter", server, server, ms=base_ms, sigma=sigma, cap_ms=cap_ms)
        )
        return self

    def slow_ramp(self, server: str, ms_per_call: float, cap_ms: float, from_call: int = 1) -> "FaultPlan":
        """Gray degradation: latency grows linearly with each call —
        ``min(cap_ms, ms_per_call * calls_since_start)`` — modeling a server
        that is slowly dying (GC spiral, disk filling) without ever erroring."""
        # plan builder (test-authored, bounded), not a serving path
        self._rules.append(
            _Rule("slow_ramp", server, server, ms=ms_per_call, cap_ms=cap_ms, start_call=from_call)
        )
        return self

    def gray_flap(self, server: str, slow_ms: float, period: int = 4) -> "FaultPlan":
        """Gray flapping: the server alternates between a slow phase and a
        fast phase every `period` calls, starting slow — the hardest case for
        breakers (never errors) and for naive outlier detection (recovers
        just long enough to look healthy)."""
        # plan builder (test-authored, bounded), not a serving path
        self._rules.append(
            _Rule("gray_flap", server, server, ms=slow_ms, period=max(1, period))
        )
        return self

    def partition(self, src: str, dst: str, on_call: Optional[int] = None) -> "FaultPlan":
        """One-way network partition: calls FROM `src` TO `dst` drop with
        ServerFaultError while dst→src (and everyone else→dst) still works.
        The caller identity arrives via on_execute(..., source=...); the
        broker's scatter path identifies itself as source="broker"."""
        calls = None if on_call is None else {on_call}
        # plan builder (test-authored, bounded), not a serving path
        self._rules.append(
            _Rule("partition", dst, dst, calls=calls, source=src)
        )
        return self

    def drop_segment(self, server: str, table: str, segment: str) -> "FaultPlan":
        """The server behaves as if it never downloaded the segment (a lost
        local copy); routing there fails with KeyError and must fail over."""
        self._dropped.add((server, table, segment))
        return self

    def flap_down(self, server: str, on_call: int = 1, of: Optional[str] = None) -> "FaultPlan":
        """Mark `server` down in the coordinator when `of` (default: the
        server itself) receives its Nth call — mid-scatter liveness loss."""
        self._rules.append(_Rule("flap_down", of or server, server, calls={on_call}))
        return self

    def flap_up(self, server: str, on_call: int, of: Optional[str] = None) -> "FaultPlan":
        self._rules.append(_Rule("flap_up", of or server, server, calls={on_call}))
        return self

    def crash_server(self, server: str, on_call: int = 1, of: Optional[str] = None) -> "FaultPlan":
        """KILL `server` (process death: segment state lost, external view
        drops it) when `of` (default: the server itself) receives its Nth
        call.  Unlike fail_server, recovery requires restart_server — the
        coordinator reconciles the rebooted server from the deep store."""
        # plan builder (test-authored, bounded), not a serving path
        self._rules.append(_Rule("crash", of or server, server, calls={on_call}))
        return self

    def restart_server(self, server: str, on_call: int, of: Optional[str] = None) -> "FaultPlan":
        """Restart a crashed `server` when `of` receives its Nth call: the
        coordinator reboots it empty, reconciles from deep store / live
        peers, and mark_up heals broker breakers mid-workload."""
        # plan builder (test-authored, bounded), not a serving path
        self._rules.append(_Rule("restart", of or server, server, calls={on_call}))
        return self

    # -- control-plane rules (coordinator HA) ------------------------------
    def pause_leader(self, node_id: str) -> "FaultPlan":
        """Freeze a coordinator process (GC pause / VM stall): every
        control-plane entry point refuses with NotLeaderError and its lease
        renewals silently stop — hold it past lease expiry and a standby
        takes over.  resume_leader() thaws it STILL BELIEVING it leads;
        its next journal append is what the epoch fence exists to stop."""
        with self._lock:
            self._paused_leaders.add(node_id)
            self.log.append((node_id, 0, "pause_leader", node_id))
        coord = self._coordinators.get(node_id)
        if coord is not None:
            coord.pause()
        return self

    def resume_leader(self, node_id: str) -> "FaultPlan":
        with self._lock:
            self._paused_leaders.discard(node_id)
            self.log.append((node_id, 0, "resume_leader", node_id))
        coord = self._coordinators.get(node_id)
        if coord is not None:
            coord.resume()
        return self

    def lease_clock_skew(self, node_id: str, ms: float) -> "FaultPlan":
        """Skew one node's view of cluster time by `ms` (positive = its
        clock runs ahead): a skewed-ahead standby sees the lease expire
        early and races the takeover — the fence, not the clock, is what
        keeps the journal single-writer."""
        with self._lock:
            self._lease_skew_ms[node_id] = float(ms)
            self.log.append((node_id, 0, "lease_clock_skew", ms))
        return self

    def journal_append_latency(self, node_id: str, ms: float) -> "FaultPlan":
        """Stall every durable journal append on `node_id` by `ms` (a slow
        fsync / contended disk): widens the window between the fence check
        and the write, which the append-under-lock discipline must keep
        safe."""
        with self._lock:
            self._journal_latency_ms[node_id] = float(ms)
            self.log.append((node_id, 0, "journal_append_latency", ms))
        return self

    # control-plane hooks (called from LeaseManager / MetaJournal)
    def allow_lease_renew(self, node_id: str) -> bool:
        with self._lock:
            paused = node_id in self._paused_leaders
            if paused:
                self.log.append((node_id, 0, "renew_suppressed", node_id))
        return not paused

    def lease_skew_ms(self, node_id: str) -> float:
        with self._lock:
            return self._lease_skew_ms.get(node_id, 0.0)

    def on_journal_append(self, node_id: str) -> None:
        with self._lock:
            self._journal_appends[node_id] = self._journal_appends.get(node_id, 0) + 1
            n = self._journal_appends[node_id]
            ms = self._journal_latency_ms.get(node_id, 0.0)
            if ms > 0:
                self.log.append((node_id, n, "journal_append_latency", ms))
        if ms > 0:
            self.sleep(ms / 1000.0)

    def kill_at(self, point: str, hit: int = 1) -> "FaultPlan":
        """Arm a named kill-point (utils/crashpoints.py): the `hit`-th time
        execution reaches crash_point(point) — between two steps of a commit
        protocol — InjectedCrash raises, simulating death at that exact
        instant.  Disarms after firing so the post-restart retry commits."""
        from pinot_tpu_torch.utils import crashpoints

        crashpoints.arm(point, hit=hit)
        self._kill_points.append(point)
        return self

    def reset_kill_points(self) -> "FaultPlan":
        """Disarm every kill-point this plan armed (test teardown)."""
        from pinot_tpu_torch.utils import crashpoints

        for p in self._kill_points:
            crashpoints.disarm(p)
        self._kill_points.clear()
        return self

    def chaos(self, servers: List[str], p_fail: float, max_calls: int = 8) -> "FaultPlan":
        """Seeded random failures: each (server, call<=max_calls) fails with
        probability p_fail, drawn ONCE at plan-build time from the plan's
        rng — two plans with the same seed script identical chaos."""
        for s in servers:
            bad = {n for n in range(1, max_calls + 1) if self.rng.random() < p_fail}
            if bad:
                self._rules.append(_Rule("fail", s, s, calls=bad, message="chaos"))
        return self

    # -- deterministic draws ----------------------------------------------
    def _jitter_ms(self, rule: _Rule, server: str, n: int) -> float:
        """Lognormal delay for call `n`, keyed on (seed, server, n) through a
        throwaway generator (random.Random seeds strings via SHA-512, stable
        across processes) so concurrent servers can't perturb each other's
        draw order — the fault sequence stays bit-deterministic."""
        draw = random.Random(f"jitter:{self.seed}:{server}:{n}")
        ms = rule.ms * draw.lognormvariate(0.0, rule.sigma)
        if rule.cap_ms > 0:
            ms = min(ms, rule.cap_ms)
        return ms

    # -- runtime hooks (called from ServerInstance.execute) ----------------
    def on_execute(self, server_name: str, source: str = "broker") -> None:
        with self._lock:
            n = self._calls[server_name] = self._calls.get(server_name, 0) + 1
            due = [
                r
                for r in self._rules
                if r.trigger == server_name
                and (r.calls is None or n in r.calls)
                and (r.kind != "partition" or r.source == source)
            ]
        for r in sorted(due, key=lambda r: _APPLY_ORDER[r.kind]):
            detail = r.target
            if r.kind == "jitter":
                detail = round(self._jitter_ms(r, server_name, n), 6)
            elif r.kind == "slow_ramp":
                if n < r.start_call:
                    continue
                detail = min(r.cap_ms, r.ms * (n - r.start_call + 1))
            elif r.kind == "gray_flap":
                if ((n - 1) // r.period) % 2 != 0:
                    continue  # fast phase: no effect, no log entry
                detail = r.ms
            elif r.kind == "partition":
                detail = r.source
            # the fault ledger IS the harness product (tests slice it by
            # index); a deque can't slice, and plans live one test long
            with self._lock:
                self.log.append((server_name, n, r.kind, detail))
            if r.kind == "latency":
                self.sleep(r.ms / 1000.0)
            elif r.kind in ("jitter", "slow_ramp", "gray_flap"):
                self.sleep(detail / 1000.0)
            elif r.kind == "partition":
                raise ServerFaultError(
                    f"injected partition: {r.source}->{server_name} dropped (call {n})"
                )
            elif r.kind == "flap_down" and self._coordinator is not None:
                self._coordinator.mark_down(r.target)
            elif r.kind == "flap_up" and self._coordinator is not None:
                self._coordinator.mark_up(r.target)
            elif r.kind == "restart" and self._coordinator is not None:
                self._coordinator.restart_server(r.target)
            elif r.kind == "crash":
                if self._coordinator is not None:
                    self._coordinator.crash_server(r.target)
                if r.target == server_name:
                    # the in-flight call on the crashing server dies with it
                    raise ServerFaultError(
                        f"injected crash: server {server_name} died (call {n})"
                    )
            elif r.kind == "fail":
                raise ServerFaultError(
                    r.message or f"injected fault: server {server_name} died (call {n})"
                )

    def segment_dropped(self, server: str, table: str, segment: str) -> bool:
        if (server, table, segment) in self._dropped:
            with self._lock:
                n = self._calls.get(server, 0)
                self.log.append((server, n, "drop_segment", segment))
            return True
        return False

    def calls(self, server: str) -> int:
        """How many execute calls the server has received under this plan."""
        with self._lock:
            return self._calls.get(server, 0)
