"""The port's durable, highly available control plane against the JAX
package's: cluster/election.py (the lease, fenced epochs, the standby's
journal follower, CoordinatorHandle) and cluster/journal.py (the fsync'd
metadata journal with compacted snapshots).

Every scenario runs in both packages (the helpers of
tests/test_torch_coordinator.py) on a simulated clock: leases expire by
advancing it, never by waiting, and CoordinatorHandle's park sleeps advance
it too.  What each returns (epochs, roles, restored control-plane states,
fault logs, counters, query rows) must agree; the port's rows are held to
a sqlite golden too.  The journal and lease files are byte-compatible:
a meta_dir one package wrote restores in the other, both ways, and the
same operations write the same bytes (creation times aside).

Every kill-point of tests/test_crash_recovery.py's journal, compaction,
add_segment and rebalance paths and of tests/test_leader_election.py's
acquire, renew, promote and fence paths is a case of
`test_kill_point_recovers`.
"""
import json
import os
import re

import pytest

from test_torch_coordinator import (  # noqa: F401  (fixtures)
    QUERIES, _jax_kill_points, assert_golden, assert_parity, build, data, golden_rows, make_cluster, pkg,
    port_state, quiet, run_both, state,
)

TTL = 2.0


class SimClock:
    """Injectable monotonic clock: the whole election runs in virtual time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> "SimClock":
        self.t += s
        return self


def ha_cluster(P, d, clock, n_servers=3, n_segments=3, rows=150):
    """Leader coordinator "coord-a" over {d}/meta + {d}/deep on the sim
    clock, with servers, table "t" and segments loaded."""
    return make_cluster(P, n_servers=n_servers, replication=2, n_segments=n_segments, rows=rows, d=d,
                        durable=True, node_id="coord-a", lease_ttl_s=TTL, clock=clock)


def standby(P, d, clock, node_id="coord-b"):
    return P.cl.Coordinator(replication=2, meta_dir=str(d / "meta"), deep_store=str(d / "deep"),
                            node_id=node_id, standby=True, lease_ttl_s=TTL, clock=clock)


def reopen(P, d, clock=None, node_id="coord-r"):
    """A fresh leader over the same meta_dir (the restart)."""
    kw = {"lease_ttl_s": TTL, "clock": clock} if clock is not None else {}
    return P.cl.Coordinator(meta_dir=str(d / "meta"), deep_store=str(d / "deep"), node_id=node_id, **kw)


def rejoin(P, d, coord, names=("server0", "server1", "server2")):
    for n in names:
        coord.register_server(P.server(n, data_dir=str(d / n)))


def t2(P):
    S = P.S
    return S.Schema("t2", [S.FieldSpec("x", S.DataType.LONG, role=S.FieldRole.METRIC)]), P.C.TableConfig(name="t2")


def counter(P, name):
    return P.METRICS.counter(name).value


def rows_of(P, coord):
    b = P.cl.Broker(coord)
    quiet(b)
    return {sql: b.query(sql).rows for sql in QUERIES[:2]}


# ---------------------------------------------------------------------------
# the lease
# ---------------------------------------------------------------------------
def test_acquire_expire_takeover_and_renew(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        a = P.election.LeaseManager(str(d), "a", ttl_s=TTL, clock=clock)
        b = P.election.LeaseManager(str(d), "b", ttl_s=TTL, clock=clock)
        out = [a.try_acquire(), a.epoch, a.is_leader, b.try_acquire()]
        clock.advance(TTL * 0.75)
        out.append(a.renew())
        clock.advance(TTL * 0.75)  # past the original deadline, not the renewed one
        out += [b.try_acquire(), b.expired()]
        clock.advance(TTL + 0.1)
        out += [b.try_acquire(), b.epoch, a.renew(), a.is_leader]
        b.release()
        out += [a.try_acquire(), a.epoch]
        return {"trail": out, "lost": counter(P, "coordinator.leadershipLost"),
                "renewals": counter(P, "coordinator.leaseRenewals")}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == [True, 1, True, False, True, False, False, True, 2, False, False, True, 3]
    assert_parity(out)


def test_fencing_force_and_equal_epoch_race(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        a = P.election.LeaseManager(str(d), "a", ttl_s=TTL, clock=clock)
        b = P.election.LeaseManager(str(d), "b", ttl_s=TTL, clock=clock)
        out = [a.try_acquire(), b.try_acquire(force=True), b.epoch]
        with pytest.raises(P.cl.FencedEpochError):
            a.validate_writer()
        out.append(a.is_leader)
        clock.advance(TTL + 0.1)
        c = P.election.LeaseManager(str(d), "c", ttl_s=TTL, clock=clock)
        out += [c.try_acquire(), c.epoch]
        b.epoch, b.is_leader = 3, True  # the race loser believes it won too
        with pytest.raises(P.cl.FencedEpochError):
            b.validate_writer()
        out.append(c.validate_writer())
        # a skewed clock sees a fresh lease as expired; the fence still holds
        skew = P.election.LeaseManager(str(d), "skew", ttl_s=TTL, clock=clock)
        skew.fault_plan = P.cl.FaultPlan().lease_clock_skew("skew", (TTL + 1) * 1000.0)
        out += [skew.expired(), c.expired(), skew.try_acquire(), skew.epoch]
        with pytest.raises(P.cl.FencedEpochError):
            c.validate_writer()
        return {"trail": out}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == [True, True, 2, False, True, 3, 3, True, False, True, 4]
    assert_parity(out)


def test_corrupt_lease_quarantines_and_stale_tmp_sweeps(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        a = P.election.LeaseManager(str(d / "l"), "a", ttl_s=TTL, clock=clock)
        os.makedirs(d / "l", exist_ok=True)
        with open(a.lease_path, "w", encoding="utf-8") as f:
            f.write('{"holder": "a", "epo')  # torn write from a dead kernel
        out = [a.read() is None, os.path.exists(a.lease_path + ".corrupt-0"), a.try_acquire(), a.is_leader]
        coord, _ = ha_cluster(P, d, clock, n_segments=1)
        del coord
        stale = d / "meta" / "lease.json.tmp"
        stale.write_text('{"holder": "ghost", "epoch": 99}')
        reopen(P, d, clock, node_id="coord-b")
        out.append(stale.exists())
        return {"trail": out, "corrupt": counter(P, "coordinator.leaseCorrupt"),
                "swept": counter(P, "coordinator.staleLeaseTmpSwept")}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == [True, True, True, True, False] and out["port"]["swept"] >= 1
    assert_parity(out)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------
def test_restart_rebuilds_identical_state(tmp_path):
    def scenario(P, d):
        coord, datas = make_cluster(P, d=d, durable=True)
        before = state(coord)
        coord2 = reopen(P, d)
        restored = state(coord2)
        rejoin(P, d, coord2)
        return {"same": restored == before, "state": restored, "view": coord2.external_view("t") ==
                coord.external_view("t"), "rows": rows_of(P, coord2), "datas": datas}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["same"] and p["view"]
    assert_golden(p["rows"], golden_rows(p.pop("datas"), QUERIES[:2]))
    out["jax"].pop("datas")
    assert_parity(out)


def test_compaction_torn_tail_and_corrupt_snapshot(tmp_path):
    def scenario(P, d):
        coord, _ = make_cluster(P, d=d, durable=True)
        before = state(coord)
        coord.checkpoint_metadata()
        out = [os.path.getsize(d / "meta" / "journal.jsonl"), state(reopen(P, d)) == before]
        with open(d / "meta" / "journal.jsonl", "a", encoding="utf-8") as f:
            f.write('{"seq": 9999, "op": "set_ideal", "table": "t", "segm')  # torn append
        out.append(state(reopen(P, d)) == before)
        coord.checkpoint_metadata()  # snapshot.json.bak now holds the same state
        with open(d / "meta" / "snapshot.json", "w", encoding="utf-8") as f:
            f.write("{ not json")
        out.append(state(reopen(P, d)) == before)
        out.append(any(p.name.startswith("snapshot.json.corrupt") for p in (d / "meta").iterdir()))
        return {"trail": out, "state": before}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == [0, True, True, True, True]
    assert_parity(out)


def _normalized(path):
    with open(path, encoding="utf-8") as f:
        return re.sub(r'"creationTimeMs":\s*\d+', '"creationTimeMs":0', f.read())


def test_journal_and_lease_files_are_byte_compatible(tmp_path):
    """The same operations write the same journal, snapshot and lease
    bytes in both packages (creation times aside), and a meta_dir one
    package wrote restores in the other, both ways."""
    root = tmp_path
    clocks = {name: SimClock() for name in ("jax", "port")}

    def scenario(P, d):
        coord, _ = ha_cluster(P, d, clocks[P.name])
        coord.mark_down("server2")
        coord.rebalance("t")
        journal = _normalized(d / "meta" / "journal.jsonl")
        coord.checkpoint_metadata()
        coord.add_table(*t2(P))
        return {"journal": journal, "journal2": _normalized(d / "meta" / "journal.jsonl"),
                "snapshot": _normalized(d / "meta" / "snapshot.json"),
                "lease": _normalized(d / "meta" / "lease.json"), "state": state(coord)}

    out = run_both(scenario, root)
    assert out["port"]["journal"].count("\n") > 5
    assert_parity(out)
    # cross restores: each package's coordinator rebuilds the other's state
    for mine, theirs in (("port", "jax"), ("jax", "port")):
        P = pkg(mine)
        coord = P.cl.Coordinator(meta_dir=str(root / theirs / "meta"), node_id="coord-x",
                                 lease_ttl_s=TTL, clock=clocks[theirs])
        assert state(coord) == out[theirs]["state"], mine
        assert coord.election.epoch == 2


# ---------------------------------------------------------------------------
# the standby
# ---------------------------------------------------------------------------
def fingerprint(coord):
    st = state(coord)
    st.pop("rtCheckpoints")
    return st


def test_standby_tails_incrementally_and_resyncs_after_compaction(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        leader, _ = ha_cluster(P, d, clock)
        sb = standby(P, d, clock)
        out = [sb.role, fingerprint(sb) == fingerprint(leader)]
        leader.add_table(*t2(P))
        out += [sb.catch_up() >= 1, "t2" in sb.tables, fingerprint(sb) == fingerprint(leader)]
        leader.checkpoint_metadata()  # snapshot + journal truncate under the tail
        leader.drop_table("t2")
        sb.catch_up()
        out += ["t2" in sb.tables, fingerprint(sb) == fingerprint(leader)]
        return {"trail": out, "applied": counter(P, "coordinator.standbyEntriesApplied") >= 1}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == ["standby", True, True, True, True, False, True]
    assert_parity(out)


def test_follower_parks_torn_line_and_drops_deposed_epochs(tmp_path):
    def scenario(P, d):
        meta = d / "meta"
        meta.mkdir(parents=True)
        path = meta / P.journal.JOURNAL_FILE
        with open(path, "w", encoding="utf-8") as f:
            f.write('{"seq": 1, "epoch": 1, "op": "noop"}\n')
            f.write('{"seq": 2, "epoch": 1, "op": "noop"}\n')
            f.write('{"seq": 3, "epoch": 1, "o')  # append died mid-line
        follower = P.cl.JournalFollower(str(meta))
        polls = [[e["seq"] for e in follower.poll()[1]]]
        with open(path, "a", encoding="utf-8") as f:
            f.write('p": "noop"}\n')  # the writer finished the line
            f.write('{"seq": 4, "epoch": 2, "op": "noop"}\n')
            f.write('{"seq": 5, "epoch": 1, "op": "zombie"}\n')  # deposed writer
            f.write('{"seq": 6, "epoch": 2, "op": "noop"}\n')
        polls.append([e["seq"] for e in follower.poll()[1]])
        return {"polls": polls, "dropped": counter(P, "coordinator.fencedReplayDropped")}

    out = run_both(scenario, tmp_path)
    assert out["port"] == {"polls": [[1, 2], [3, 4, 6]], "dropped": 1}
    assert_parity(out)


# ---------------------------------------------------------------------------
# split brain
# ---------------------------------------------------------------------------
def test_zombie_leader_is_fenced_and_replay_matches(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        leader, _ = ha_cluster(P, d, clock)
        plan = P.cl.FaultPlan().attach_coordinator(leader)
        sb = standby(P, d, clock)
        plan.attach_coordinator(sb)
        plan.pause_leader("coord-a")
        clock.advance(TTL + 0.1)
        out = [sb.run_election_tick(), sb.election.epoch]
        sb.add_table(*t2(P))
        plan.resume_leader("coord-a")
        out.append(leader.role)
        with pytest.raises(P.cl.FencedEpochError):
            leader.drop_table("t")
        out.append(leader.role)
        with open(d / "meta" / P.journal.JOURNAL_FILE, encoding="utf-8") as f:
            epochs = [json.loads(line)["epoch"] for line in f if line.strip()]
        third = reopen(P, d, clock, node_id="coord-c")
        return {"trail": out, "epochs": epochs, "third": sorted(third.tables),
                "same": fingerprint(third) == fingerprint(sb), "fenced": counter(P, "coordinator.fencedAppends")}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["trail"] == ["leader", 2, "leader", "standby"] and p["same"] and p["fenced"] == 1
    assert p["epochs"] == sorted(p["epochs"]) and set(p["epochs"]) == {1, 2}
    assert_parity(out)


def test_deposed_leader_rejoins_as_a_tailing_standby(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        leader, _ = ha_cluster(P, d, clock)
        plan = P.cl.FaultPlan().attach_coordinator(leader)
        sb = standby(P, d, clock)
        plan.attach_coordinator(sb)
        plan.pause_leader("coord-a")
        clock.advance(TTL + 0.1)
        out = [sb.run_election_tick()]
        plan.resume_leader("coord-a")
        out.append(leader.run_election_tick())
        sb.add_table(*t2(P))
        leader.run_election_tick()
        out += ["t2" in leader.tables, fingerprint(leader) == fingerprint(sb)]
        return {"trail": out}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == ["leader", "standby", True, True]
    assert_parity(out)


def test_paused_leader_refuses_writes_serves_reads_and_logs_faults(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        leader, datas = ha_cluster(P, d, clock)
        plan = P.cl.FaultPlan().attach_coordinator(leader)
        base = rows_of(P, leader)
        plan.pause_leader("coord-a")
        with pytest.raises(P.cl.NotLeaderError):
            leader.mark_down("server0")
        paused = rows_of(P, leader)
        renewed = leader.election.renew()  # the frozen process's renewal never happens
        plan.resume_leader("coord-a")
        plan.journal_append_latency("coord-a", 50.0)
        slept = []
        plan.sleep = slept.append
        leader.add_table(*t2(P))
        return {"base": base, "paused": paused, "renewed": renewed, "slept": slept,
                "log": [e[2] for e in plan.log], "renewals": counter(P, "coordinator.leaseRenewals"),
                "datas": datas}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["renewed"] is True and p["slept"] == [0.05] and "renew_suppressed" in p["log"]
    assert_golden(p["paused"], golden_rows(p.pop("datas"), QUERIES[:2]))
    out["jax"].pop("datas")
    assert_parity(out)


# ---------------------------------------------------------------------------
# CoordinatorHandle
# ---------------------------------------------------------------------------
def handled_cluster(P, d, clock):
    """Leader + hot standby behind a CoordinatorHandle whose park sleeps
    advance the sim clock (the park's auto-tick promotes the standby once
    the lease expires)."""
    leader, datas = ha_cluster(P, d, clock)
    plan = P.cl.FaultPlan().attach_coordinator(leader)
    sb = standby(P, d, clock)
    plan.attach_coordinator(sb)
    handle = P.cl.CoordinatorHandle([leader, sb], sleep=lambda s: clock.advance(s), clock=clock)
    for name, s in leader.servers.items():
        handle._servers[name] = s  # registered before the handle existed
    return leader, sb, plan, handle, datas


def test_handle_parks_across_the_failover_and_times_out_alone(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        leader, sb, plan, handle, _ = handled_cluster(P, d / "a", clock)
        plan.pause_leader("coord-a")
        handle.add_table(*t2(P))  # parks, the auto-tick promotes, the write lands
        out = [sb.role, "t2" in sb.tables, handle.election_snapshot()["leader"],
               counter(P, "coordinator.failoverParksServed") >= 1]
        clock2 = SimClock()
        lone, _ = ha_cluster(P, d / "b", clock2, n_segments=1)
        plan2 = P.cl.FaultPlan().attach_coordinator(lone)
        h2 = P.cl.CoordinatorHandle([lone], park_ms=200, retries=1, sleep=lambda s: clock2.advance(s),
                                     clock=clock2)
        plan2.pause_leader("coord-a")  # no standby: nothing can take over
        with pytest.raises(P.cl.NotLeaderError):
            h2.mark_down("server0")
        out.append(counter(P, "coordinator.failoverParkTimeouts") >= 1)
        out.append(P.cl.Broker(lone).election_snapshot()["candidates"][0]["role"])
        return {"trail": out}

    out = run_both(scenario, tmp_path)
    assert out["port"]["trail"] == ["leader", True, "coord-b", True, True, "leader"]
    assert_parity(out)


def test_data_plane_never_parks_during_blackout(tmp_path):
    def scenario(P, d):
        clock = SimClock()
        leader, sb, plan, handle, datas = handled_cluster(P, d, clock)
        broker = P.cl.Broker(handle)
        base = {sql: broker.query(sql).rows for sql in QUERIES}
        plan.pause_leader("coord-a")
        t0 = clock.t
        during = {sql: broker.query(sql).rows for sql in QUERIES}
        parked = clock.t - t0
        handle.heartbeat("server0")  # the control plane parks and promotes
        after = {sql: broker.query(sql).rows for sql in QUERIES}
        return {"base": base, "during": during, "after": after, "parked": parked, "role": sb.role,
                "datas": datas}

    out = run_both(scenario, tmp_path)
    p = out["port"]
    assert p["parked"] == 0 and p["role"] == "leader"
    gold = golden_rows(p.pop("datas"))
    for k in ("base", "during", "after"):
        assert_golden(p[k], gold)
    out["jax"].pop("datas")
    assert_parity(out)


# ---------------------------------------------------------------------------
# every kill-point
# ---------------------------------------------------------------------------
def _lease_acquire(P, d, point):
    clock = SimClock()
    a = P.election.LeaseManager(str(d), "a", ttl_s=TTL, clock=clock)
    P.crash.arm(point)
    with pytest.raises(P.cl.InjectedCrash):
        a.try_acquire()
    b = P.election.LeaseManager(str(d), "b", ttl_s=TTL, clock=clock)
    cur = b.read()
    out = [None if cur is None else (cur.holder, cur.epoch), os.path.exists(a.lease_path + ".tmp")]
    b.sweep_stale_tmp()
    out += [os.path.exists(a.lease_path + ".tmp"), b.try_acquire()]
    clock.advance(TTL + 0.1)
    out += [b.try_acquire(), b.epoch]
    return out


def _lease_renew(P, d, point):
    clock = SimClock()
    a = P.election.LeaseManager(str(d), "a", ttl_s=TTL, clock=clock)
    a.try_acquire()
    clock.advance(0.5)
    P.crash.arm(point)
    with pytest.raises(P.cl.InjectedCrash):
        a.renew()
    cur = P.election.LeaseManager(str(d), "b", ttl_s=TTL, clock=clock).read()
    return [cur.holder, cur.epoch, cur.expires_at]


def _promote(P, d, point):
    clock = SimClock()
    leader, _ = ha_cluster(P, d, clock)
    plan = P.cl.FaultPlan().attach_coordinator(leader)
    sb = standby(P, d, clock)
    plan.attach_coordinator(sb)
    plan.pause_leader("coord-a")
    clock.advance(TTL + 0.1)
    plan.kill_at(point)
    with pytest.raises(P.cl.InjectedCrash):
        sb.run_election_tick()
    return [sb.role, sb.run_election_tick(), sb.journal is not None, sb.election.is_leader]


def _journal_write(P, d, point):
    """A table add dies at the fence or mid-append: it never commits."""
    clock = SimClock()
    leader, _ = ha_cluster(P, d, clock)
    before = fingerprint(leader)
    P.crash.arm(point)
    with pytest.raises(P.cl.InjectedCrash):
        leader.add_table(*t2(P))
    replayed = reopen(P, d, clock)
    return ["t2" in replayed.tables, fingerprint(replayed) == before]


def _compaction(P, d, point):
    coord, _ = make_cluster(P, d=d, durable=True)
    coord.checkpoint_metadata()  # a previous snapshot exists
    coord.add_segment("t", build(P, data(50, seed=999), "seg_late", out=d / "build" / "seg_late"))
    before = state(coord)
    P.crash.arm(point)
    with pytest.raises(P.cl.InjectedCrash):
        coord.checkpoint_metadata()
    return [state(reopen(P, d)) == before]


def _add_segment(P, d, point):
    """The coordinator dies mid add_segment and restarts from its journal;
    then the same through a CoordinatorHandle onto a promoted standby."""
    coord, datas = make_cluster(P, d=d / "a", durable=True)
    seg = build(P, data(50, seed=999), "seg_late", out=d / "a" / "build" / "seg_late")
    P.crash.arm(point)
    with pytest.raises(P.cl.InjectedCrash):
        coord.add_segment("t", seg)
    coord2 = reopen(P, d / "a")
    committed = "seg_late" in coord2.tables["t"].ideal
    rejoin(P, d / "a", coord2)
    holders = sorted(n for n, s in coord2.servers.items() if s.get_segment("t", "seg_late") is not None)
    count = P.cl.Broker(coord2).query("SELECT COUNT(*) FROM t").rows
    # through the handle: the new leader's journal decides, the retry is the first commit
    clock = SimClock()
    leader, sb, plan, handle, _ = handled_cluster(P, d / "b", clock)
    broker = P.cl.Broker(handle)
    seg_b = build(P, data(80, seed=999), "seg_late", out=d / "b" / "build" / "seg_late")
    plan.kill_at(point)
    with pytest.raises(P.cl.InjectedCrash):
        handle.add_segment("t", seg_b)
    plan.pause_leader("coord-a")  # the crashed process never comes back
    handle.heartbeat("server0")
    committed_b = "seg_late" in sb.tables["t"].ideal
    if not committed_b:
        handle.add_segment("t", seg_b)
    res = broker.query("SELECT COUNT(*) FROM t")
    return [committed, holders == sorted(coord2.tables["t"].ideal.get("seg_late", ())), count,
            committed_b, sb.role, res.rows, res.stats.partial_result]


def _rebalance(P, d, point):
    """Rebalance dies mid-move; the restarted coordinator reconciles its
    servers and the retried rebalance converges; then the same on a
    promoted standby behind a CoordinatorHandle."""
    coord, datas = make_cluster(P, n_servers=2, replication=2, n_segments=6, d=d / "a", durable=True)
    gold = golden_rows(datas, QUERIES[:2])
    coord.register_server(P.server("server_new", data_dir=str(d / "a" / "server_new")))
    P.crash.arm(point)
    with pytest.raises(P.cl.InjectedCrash):
        coord.rebalance("t")
    coord2 = reopen(P, d / "a")
    rejoin(P, d / "a", coord2, ("server0", "server1", "server_new"))
    served = all(coord2.servers[n].get_segment("t", seg) is not None
                 for seg, names in coord2.tables["t"].ideal.items() for n in names)
    rows = [rows_of(P, coord2)]
    coord2.rebalance("t")
    rows.append(rows_of(P, coord2))
    for r in rows:
        assert_golden(r, gold)
    out = [served, rows, state(coord2)["tables"]["t"]["ideal"]]
    if point == "rebalance.after_add":
        clock = SimClock()
        leader, sb, plan, handle, _ = handled_cluster(P, d / "b", clock)
        broker = P.cl.Broker(handle)
        base = {sql: broker.query(sql).rows for sql in QUERIES}
        handle.register_server(P.server("server3", data_dir=str(d / "b" / "server3")))
        plan.kill_at(point)
        with pytest.raises(P.cl.InjectedCrash):
            handle.rebalance("t")
        plan.pause_leader("coord-a")
        handle.rebalance("t")
        after = {sql: broker.query(sql) for sql in QUERIES}
        out += [sb.role, [len(s) for s in sb.tables["t"].ideal.values()],
                {sql: r.rows for sql, r in after.items()} == base,
                [r.stats.partial_result for r in after.values()]]
    return out


KILL_POINTS = {
    "election.acquire.after_write": _lease_acquire,
    "election.acquire.after_replace": _lease_acquire,
    "election.renew.after_write": _lease_renew,
    "election.renew.after_replace": _lease_renew,
    "election.promote.after_acquire": _promote,
    "journal.append.before_fence": _journal_write,
    "journal.append.after_fence": _journal_write,
    "journal.append.after_write": _journal_write,
    "journal.snapshot.after_bak": _compaction,
    "journal.snapshot.after_write": _compaction,
    "journal.snapshot.before_truncate": _compaction,
    "coordinator.add_segment.after_upload": _add_segment,
    "coordinator.add_segment.after_journal": _add_segment,
    "rebalance.after_add": _rebalance,
    "rebalance.after_commit": _rebalance,
}

EXPECTED = {
    "election.acquire.after_write": [None, True, False, True, True, 2],
    "election.acquire.after_replace": [("a", 1), False, False, False, True, 2],
    "election.renew.after_write": ["a", 1, TTL],
    "election.renew.after_replace": ["a", 1, 0.5 + TTL],
    "election.promote.after_acquire": ["standby", "leader", True, True],
    "journal.append.before_fence": [False, True],
    "journal.append.after_fence": [False, True],
    "journal.append.after_write": [False, True],
    "journal.snapshot.after_bak": [True],
    "journal.snapshot.after_write": [True],
    "journal.snapshot.before_truncate": [True],
    "coordinator.add_segment.after_upload": [False, True, [(800,)], False, "leader", [(3 * 150 + 80,)], False],
    "coordinator.add_segment.after_journal": [True, True, [(850,)], True, "leader", [(3 * 150 + 80,)], False],
}


@pytest.mark.parametrize("point", list(KILL_POINTS))
def test_kill_point_recovers(point, tmp_path):
    out = run_both(lambda P, d: {"out": KILL_POINTS[point](P, d, point),
                                 "fired": [f[0] for f in P.crash.fired]}, tmp_path)
    p = out["port"]
    assert p["fired"] and set(p["fired"]) == {point}
    if point in EXPECTED:
        assert p["out"] == EXPECTED[point]
    if point == "rebalance.after_add":
        assert p["out"][3:] == ["leader", [2] * 3, True, [False] * len(QUERIES)]
    assert_parity(out)
