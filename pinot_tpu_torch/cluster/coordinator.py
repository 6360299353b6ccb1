"""Coordinator: table/segment metadata, assignment, rebalance, retention.

Reference parity: PinotHelixResourceManager (pinot-controller/.../helix/core/
PinotHelixResourceManager.java — addTable :2045, addNewSegment :3037 ->
assignSegment :3056), assignment strategies (.../core/assignment/segment/),
TableRebalancer.rebalance (.../rebalance/TableRebalancer.java:201, contract
:122-134: never drop below min-available replicas), RetentionManager and
SegmentStatusChecker periodic tasks.

Re-design: ideal state / external view are dicts owned by this object (the
ZK-free control plane of SURVEY.md §2.6); servers register directly.  What
the reference persists to ZooKeeper persists here through an optional
durable metadata journal (cluster/journal.py: fsync'd JSONL + compacted
snapshots) — every mutation (table CRUD, segment assignment, replica-group
membership, rebalance commits, retention drops, realtime checkpoint
pointers) appends before it applies, so a coordinator built over the same
meta_dir after a crash rebuilds IDENTICAL ideal state, and re-registering
servers reconcile their local segment sets against it (re-downloading
missing/corrupt copies from the segment deep store, cluster/deepstore.py).
The routing view is versioned: every ideal-state or live-set transition
bumps `version`, so rebalance moves commit a new routing view instead of
mutating the one in-flight queries routed on.

Port of pinot_tpu/cluster/coordinator.py (host only).  It touches the card
only through the ServerInstances registered with it; replicas of a segment
are one segment object on every server that holds it.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from pinot_tpu_torch.cluster.election import FencedEpochError, NotLeaderError
from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.spi.config import TableConfig
from pinot_tpu_torch.spi.schema import Schema
from pinot_tpu_torch.utils.crashpoints import crash_point

log = logging.getLogger("pinot_tpu_torch.cluster")


def _jsonable(v: Any) -> Any:
    """Journal-safe JSON form: numpy and torch scalars unwrap, tuples/sets
    become lists, bytes hex-tag themselves (restored by _unjsonable)."""
    if isinstance(v, np.generic) or (isinstance(v, torch.Tensor) and v.dim() == 0):
        v = v.item()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(_jsonable(x) for x in v)
    if isinstance(v, bytes):
        return {"__bytes__": v.hex()}
    return v


def _unjsonable(v: Any) -> Any:
    if isinstance(v, dict):
        if set(v) == {"__bytes__"}:
            return bytes.fromhex(v["__bytes__"])
        return {k: _unjsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unjsonable(x) for x in v]
    return v


def _restore_seg_meta(sm: Dict[str, Any]) -> Dict[str, Any]:
    """Segment metadata back from its journaled JSON form: the fields the
    broker pruners index positionally come back as tuples."""
    sm = dict(_unjsonable(sm))
    if sm.get("timeRange") is not None:
        sm["timeRange"] = tuple(sm["timeRange"])
    if sm.get("partition") is not None:
        sm["partition"] = tuple(sm["partition"])
    return sm


@dataclass
class TableMeta:
    schema: Schema
    config: TableConfig
    # ideal state: segment name -> set of server names that SHOULD serve it
    ideal: Dict[str, Set[str]] = field(default_factory=dict)
    # segment metadata the broker prunes on (time range, partition, docs)
    segment_meta: Dict[str, Dict] = field(default_factory=dict)


class Coordinator:
    def __init__(
        self,
        replication: int = 1,
        meta_dir: Optional[str] = None,
        deep_store=None,
        node_id: Optional[str] = None,
        standby: bool = False,
        lease_ttl_s: Optional[float] = None,
        clock=None,
    ):
        """`meta_dir` enables the durable control plane: mutations journal
        to {meta_dir}/journal.jsonl (+ compacted snapshots) and a fresh
        Coordinator over the same directory restores identical state.
        `deep_store` (a SegmentDeepStore or root path) is the durable
        segment home servers re-download from after a crash.

        Coordinator HA: a durable `meta_dir` also carries the
        leadership lease (cluster/election.py).  A non-standby boot FORCE
        acquires it — the operator restarting a coordinator over its own
        directory takes over, and the epoch bump fences any zombie of the
        previous process.  `standby=True` boots a HOT STANDBY instead: it
        tails the leader's journal incrementally (never writing the
        directory) and `promote()` — or `run_election_tick()` once the
        lease expires — makes it the fenced leader.  `clock`/`lease_ttl_s`
        parameterize the lease for tests and the smoke script (injectable
        clock; lease math never reads the wall clock)."""
        self.replication = replication
        self.tables: Dict[str, TableMeta] = {}
        self.servers: Dict[str, "ServerInstance"] = {}  # noqa: F821
        self.live: Set[str] = set()
        # REALTIME tables: name -> RealtimeTableDataManager (coordinator-
        # owned consuming lifecycle; see add_realtime_table)
        self.realtime: Dict[str, object] = {}
        # replica-group membership: server -> group id (round-robin on join)
        self.replica_group: Dict[str, int] = {}
        self.num_replica_groups = max(1, replication)
        # group assignment reads len(replica_group) then writes it: two
        # servers joining concurrently would land in the same group
        self._membership_lock = threading.Lock()
        # live-set transition listeners: fn(server_name, is_up) — brokers
        # subscribe so circuit-breaker state resets when a server recovers
        self._live_listeners: List[Any] = []
        # versioned routing view: bumps on every ideal-state / live-set
        # mutation, so rebalance commits a NEW view instead of mutating the
        # one concurrent queries routed on
        self.version = 0
        # realtime table data dirs (journaled so a restored coordinator can
        # recover_realtime without the caller re-stating them)
        self._rt_dirs: Dict[str, str] = {}
        # last journaled realtime checkpoint pointer per (table, partition)
        self.rt_checkpoints: Dict[str, Dict[int, Dict[str, int]]] = {}
        if deep_store is not None and not hasattr(deep_store, "has_segment"):
            from pinot_tpu_torch.cluster.deepstore import SegmentDeepStore

            deep_store = SegmentDeepStore(str(deep_store))
        self.deep_store = deep_store
        self.journal = None
        self.node_id = node_id or "coordinator"
        # a coordinator without a durable control plane is trivially the
        # leader of its single-process cluster
        self.role = "leader"
        self.election = None
        self._follower = None
        self._paused = False  # sim harness: a GC-frozen process serves nothing
        self.fault_plan = None  # set by FaultPlan.attach_coordinator
        if standby and meta_dir is None:
            raise ValueError("a standby coordinator requires meta_dir (it tails the leader's journal)")
        if meta_dir is not None:
            from pinot_tpu_torch.cluster.election import JournalFollower, LeaseManager
            from pinot_tpu_torch.cluster.journal import MetaJournal

            self.election = LeaseManager(
                meta_dir, self.node_id, ttl_s=lease_ttl_s, clock=clock
            )
            if standby:
                self.role = "standby"
                self._follower = JournalFollower(meta_dir)
                state = self._follower.bootstrap()
                if state:
                    self._apply_state(state)
                self.catch_up()
            else:
                # boot-time takeover: sweep crash leftovers (a stale
                # lease.json.tmp must never look like a live lease), then
                # force-acquire — the epoch bump fences any zombie writer
                self.election.sweep_stale_tmp()
                self.election.try_acquire(force=True)
                self.journal = MetaJournal(meta_dir)
                self.journal.fence = self.election
                if not self._restore():
                    # fresh journal: pin the cluster-wide invariants so a
                    # restored coordinator doesn't fall back to ctor defaults
                    self._journal(
                        "init",
                        replication=self.replication,
                        numReplicaGroups=self.num_replica_groups,
                    )

    # -- durable control plane -------------------------------------------
    def _journal(self, op: str, **data: Any) -> None:
        if self.journal is None:
            return
        try:
            self.journal.append(op, **data)
        except FencedEpochError:
            # the epoch fence tripped: leadership moved past us while we
            # thought we held it.  A deposed leader CANNOT commit — demote
            # to standby (the handle re-resolves) and surface the
            # structured error to the caller's retry path
            self._demote(release_lease=False)
            raise
        if self.journal.should_compact():
            self.journal.snapshot(self._state_dict())

    def _bump_version(self) -> None:
        with self._membership_lock:
            self.version += 1

    def _state_dict(self) -> Dict[str, Any]:
        """Full snapshot-able control-plane state (everything a restarted
        coordinator needs to rebuild identical ideal state)."""
        with self._membership_lock:
            groups = dict(self.replica_group)
        tables = {}
        for name, meta in self.tables.items():
            tables[name] = {
                "schema": meta.schema.to_dict(),
                "config": meta.config.to_dict(),
                "ideal": {seg: sorted(srvs) for seg, srvs in meta.ideal.items()},
                "segmentMeta": _jsonable(meta.segment_meta),
                "realtimeDataDir": self._rt_dirs.get(name),
            }
        return {
            "replication": self.replication,
            "numReplicaGroups": self.num_replica_groups,
            "tables": tables,
            "replicaGroup": groups,
            "rtCheckpoints": _jsonable(self.rt_checkpoints),
        }

    def _restore(self) -> bool:
        """Rebuild control-plane state from snapshot + journal replay.
        Servers are NOT live afterwards — they re-register and reconcile.
        Returns whether any durable state existed."""
        state, entries = self.journal.load()
        if state:
            self._apply_state(state)
        for entry in entries:
            self._apply_entry(entry)
        if state or entries:
            self._bump_version()
            return True
        return False

    def _apply_state(self, state: Dict[str, Any]) -> None:
        self.replication = int(state.get("replication", self.replication))
        self.num_replica_groups = int(state.get("numReplicaGroups", self.num_replica_groups))
        with self._membership_lock:
            self.replica_group = {
                str(k): int(v) for k, v in (state.get("replicaGroup") or {}).items()
            }
        for name, t in (state.get("tables") or {}).items():
            meta = TableMeta(
                schema=Schema.from_dict(t["schema"]),
                config=TableConfig.from_dict(t["config"]),
            )
            meta.ideal = {seg: set(srvs) for seg, srvs in (t.get("ideal") or {}).items()}
            meta.segment_meta = {
                seg: _restore_seg_meta(sm) for seg, sm in (t.get("segmentMeta") or {}).items()
            }
            self.tables[name] = meta
            if t.get("realtimeDataDir"):
                self._rt_dirs[name] = t["realtimeDataDir"]
        for table, parts in (state.get("rtCheckpoints") or {}).items():
            self.rt_checkpoints[table] = {
                int(p): dict(cp) for p, cp in (parts or {}).items()
            }

    def _apply_entry(self, entry: Dict[str, Any]) -> None:
        """Replay one journal entry.  Every op is idempotent (set-valued
        ideal state, last-writer pointers) so the snapshot/journal overlap a
        crash mid-compaction produces re-applies harmlessly."""
        op = entry.get("op")
        if op == "init":
            self.replication = int(entry.get("replication", self.replication))
            self.num_replica_groups = int(
                entry.get("numReplicaGroups", self.num_replica_groups)
            )
        elif op == "add_table":
            name = entry["table"]
            if name not in self.tables:
                self.tables[name] = TableMeta(
                    schema=Schema.from_dict(entry["schema"]),
                    config=TableConfig.from_dict(entry["config"]),
                )
            if entry.get("realtimeDataDir"):
                self._rt_dirs[name] = entry["realtimeDataDir"]
        elif op == "drop_table":
            self.tables.pop(entry["table"], None)
            self._rt_dirs.pop(entry["table"], None)
            self.rt_checkpoints.pop(entry["table"], None)
        elif op == "set_ideal":
            meta = self.tables.get(entry["table"])
            if meta is not None:
                meta.ideal[entry["segment"]] = set(entry["servers"])
                if entry.get("meta") is not None:
                    meta.segment_meta[entry["segment"]] = _restore_seg_meta(entry["meta"])
        elif op == "drop_segment":
            meta = self.tables.get(entry["table"])
            if meta is not None:
                meta.ideal.pop(entry["segment"], None)
                meta.segment_meta.pop(entry["segment"], None)
        elif op == "register_server":
            with self._membership_lock:
                self.replica_group[entry["server"]] = int(entry["group"])
        elif op == "rt_checkpoint":
            self.rt_checkpoints.setdefault(entry["table"], {})[int(entry["partition"])] = {
                "offset": int(entry["offset"]),
                "seq": int(entry["segSeq"]),
            }
        else:  # forward-compat: unknown ops are recorded, not fatal
            log.warning("unknown journal op %r (seq %s) ignored", op, entry.get("seq"))

    def checkpoint_metadata(self) -> None:
        """Force a compacted snapshot now (periodic-task / shutdown hook)."""
        if self.journal is not None:
            self.journal.snapshot(self._state_dict())

    # -- leadership (lease-based election, cluster/election.py) -----------
    def _require_leader(self) -> None:
        """Gate on every control-plane mutation: standbys (and paused
        processes) refuse with the structured error CoordinatorHandle
        retries on.  This is the cheap in-memory check — the EPOCH FENCE in
        the journal is the authority for durable writes (a stale leader's
        non-journaled op may briefly succeed here, exactly like the
        reference's external-view lag; anything durable cannot)."""
        if self._paused:
            raise NotLeaderError(f"coordinator {self.node_id} is paused (frozen process)")
        if self.role != "leader":
            raise NotLeaderError(
                f"coordinator {self.node_id} is a standby (control-plane "
                "writes go to the leader)",
            )

    def pause(self) -> None:
        """Simulation harness: freeze this process (GC pause / VM stall).
        Every control-plane entry point refuses while paused; lease
        renewals silently stop (the FaultPlan leader_pause rule drives
        this).  Data-plane reads stay up — brokers ride the last versioned
        routing view, which this object still holds."""
        self._paused = True

    def resume(self) -> None:
        """Unfreeze.  The process still believes it leads (role unchanged);
        if the lease moved on while frozen, its next journal append trips
        the epoch fence and demotes it — the split-brain proof."""
        self._paused = False

    def catch_up(self) -> int:
        """Standby: apply newly committed journal entries (incremental tail
        over the shared TailFollower).  Returns entries applied."""
        if self._follower is None:
            return 0
        state, entries = self._follower.poll()
        if state is not None:
            # the leader compacted under us: resync from its snapshot
            self._reset_state()
            self._apply_state(state)
        for entry in entries:
            self._apply_entry(entry)
        if state is not None or entries:
            self._bump_version()
            from pinot_tpu_torch.utils.metrics import METRICS

            METRICS.counter("coordinator.standbyEntriesApplied").inc(len(entries))
        return len(entries)

    def _reset_state(self) -> None:
        """Drop replayable control-plane state before a snapshot resync
        (membership/live/listeners survive — they are runtime, not
        journaled, state)."""
        self.tables.clear()
        self._rt_dirs.clear()
        self.rt_checkpoints.clear()
        with self._membership_lock:
            self.replica_group.clear()

    def promote(self, force: bool = False) -> bool:
        """Standby -> leader: acquire the lease (bumping the epoch — the
        fencing token every subsequent append carries), replay the journal
        to tip, attach the fence, serve.  Polite by default: returns False
        while the current lease is live (set `force` for an operator
        override).  Idempotent on an already-leading coordinator."""
        if self.role == "leader":
            return True
        if self.election is None or self._follower is None:
            raise RuntimeError("promote() needs a durable meta_dir standby")
        from pinot_tpu_torch.cluster.journal import MetaJournal
        from pinot_tpu_torch.utils.metrics import METRICS

        t0 = time.perf_counter()
        self.catch_up()  # drain what the old leader committed
        if not self.election.try_acquire(force=force):
            return False
        crash_point("election.promote.after_acquire")
        # now the directory is OURS: sweep crash leftovers and drain
        # anything that fsync'd between the first drain and the acquisition
        self.election.sweep_stale_tmp()
        self.catch_up()
        # become the journal's writer: adopt the committed seq (load also
        # truncates a torn tail so our appends start on a clean line)
        journal = MetaJournal(self.election.meta_dir)
        journal.fence = self.election
        journal.fault_plan = self.fault_plan
        _state, _entries = journal.load()
        if self._follower.last_seq != journal.seq:
            # the incremental tail diverged from an authoritative load
            # (quarantined corruption it skipped past): full resync
            METRICS.counter("coordinator.promoteResyncs").inc()
            log.warning(
                "standby %s tail (seq %d) != journal tip (seq %d); full replay",
                self.node_id, self._follower.last_seq, journal.seq,
            )
            self._reset_state()
            if _state:
                self._apply_state(_state)
            for entry in _entries:
                self._apply_entry(entry)
        self.journal = journal
        self._follower = None
        self.role = "leader"
        self._bump_version()
        self.last_promote_ms = (time.perf_counter() - t0) * 1000.0
        METRICS.counter("coordinator.failovers").inc()
        METRICS.gauge("coordinator.isLeader").set(1)
        log.warning(
            "coordinator %s promoted to leader at epoch %d (replay-to-tip %.1f ms)",
            self.node_id, self.election.epoch, self.last_promote_ms,
        )
        return True

    def _demote(self, release_lease: bool) -> None:
        """Leader -> standby.  `release_lease` distinguishes a voluntary
        step-down (expire the lease now so a standby takes over instantly)
        from being DEPOSED (the lease belongs to the new leader — touching
        it would be exactly the zombie write the fence exists to stop)."""
        from pinot_tpu_torch.cluster.election import JournalFollower
        from pinot_tpu_torch.utils.metrics import METRICS

        if self.role != "leader" or self.election is None:
            return
        seq = 0
        if self.journal is not None:
            seq = self.journal.seq
            self.journal.close()
            self.journal = None
        if release_lease:
            self.election.release()
        else:
            self.election.is_leader = False
        follower = JournalFollower(self.election.meta_dir)
        # our in-memory state matches the committed prefix (journal-before-
        # apply, and the fence refuses before any byte lands): tail from it
        follower.last_seq = seq
        follower.max_epoch = self.election.epoch
        self._follower = follower
        self.role = "standby"
        METRICS.gauge("coordinator.isLeader").set(0)
        log.warning("coordinator %s demoted to standby (epoch %d)", self.node_id, self.election.epoch)

    def demote(self) -> None:
        """Voluntary step-down (operator drain): release the lease so a
        standby can take over without waiting out the TTL."""
        self._demote(release_lease=True)

    def run_election_tick(self) -> str:
        """One deterministic step of the leadership watch loop (tests, the
        bench, and CoordinatorHandle's failover park drive this; a real
        deployment would run it on a timer thread): leaders renew their
        lease (demoting when deposed), standbys tail the journal and take
        over an expired lease.  Returns the role after the tick."""
        if self.election is None or self._paused:
            return self.role
        if self.role == "leader":
            if not self.election.renew():
                self._demote(release_lease=False)
        else:
            self.catch_up()
            cur = self.election.read()
            # take over an expired lease — or finish our OWN half-done
            # acquisition (a crash between lease acquire and journal
            # adoption leaves the lease held but the role standby)
            if self.election.expired() or (
                cur is not None and cur.holder == self.election.node_id
            ):
                self.promote()
        return self.role

    def election_state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"node": self.node_id, "role": self.role, "paused": self._paused}
        if self.election is not None:
            out.update(self.election.snapshot())
        journal = self.journal
        if journal is not None:
            out["journalSeq"] = journal.seq
        elif self._follower is not None:
            out["journalSeq"] = self._follower.last_seq
        return out

    def election_snapshot(self) -> Dict[str, Any]:
        """Single-coordinator form of CoordinatorHandle.election_snapshot
        (REST /debug/election works against either)."""
        return {
            "leader": self.node_id if self.role == "leader" else None,
            "candidates": [self.election_state()],
        }

    def on_live_change(self, fn) -> None:
        self._live_listeners.append(fn)

    def _notify_live(self, name: str, up: bool) -> None:
        from pinot_tpu_torch.utils.metrics import METRICS

        for fn in list(self._live_listeners):
            try:
                fn(name, up)
            except Exception:  # noqa: BLE001 — one bad listener must not block transitions
                METRICS.counter("liveListenerErrors").inc()
                log.exception("live-set listener failed for %s", name)

    # -- instance lifecycle (Helix participant analog) -------------------
    def register_server(self, server) -> None:
        self._require_leader()
        # attach the per-server device-memory reservation ledger (cluster/admission.py):
        # scatter calls reserve their working-set estimate against it before
        # launching, so concurrent queries can't jointly overcommit the card.
        # Constructed outside the membership lock (it publishes a gauge).
        if getattr(server, "budget", None) is None:
            from pinot_tpu_torch.cluster.admission import ResourceBudget, default_server_hbm_budget

            hbm = default_server_hbm_budget()
            if hbm > 0:
                server.budget = ResourceBudget(
                    hbm, gauge=f"server.reservedBytes.{server.name}"
                )
        # attach the tiered-storage residency manager (segment/residency.py): device memory
        # becomes a cost-aware cache over the segments' host arrays, so
        # ASSIGNMENT NO LONGER ASSUMES FULL PINNING — a server can own a
        # working set larger than device memory and page it through the
        # cache budget with staged prefetch.  Its cache ledger is a
        # SEPARATE ResourceBudget from server.budget: reservations meter
        # in-flight scatter windows, the residency budget meters resident
        # cached bytes (PINOT_TPU_HBM_CACHE_BYTES=0 disables tiering).
        if getattr(server, "residency", None) is None:
            from pinot_tpu_torch.segment.residency import default_residency

            server.residency = default_residency(name=f"residency.{server.name}")
        with self._membership_lock:
            self.servers[server.name] = server
            self.live.add(server.name)
            known = server.name in self.replica_group
            if not known:
                self.replica_group[server.name] = len(self.replica_group) % self.num_replica_groups
            group = self.replica_group[server.name]
            self.version += 1
        if not known:
            # membership is durable state: a restored coordinator must place
            # segments into the same replica groups it journaled
            self._journal("register_server", server=server.name, group=group)
        # restart recovery: a (re-)registering server reconciles its local
        # segment set against the journaled ideal state — re-downloading
        # missing/corrupt copies from the deep store, dropping stale ones
        self.reconcile_server(server)
        self._notify_live(server.name, up=True)

    def reconcile_server(self, server) -> Dict[str, int]:
        """Bring one server's local segment set in line with ideal state
        (the Helix state-transition batch a re-joining participant runs).
        Missing segments restore from the deep store (CRC-verified) or a
        live peer's copy; segments ideal no longer assigns here drop."""
        from pinot_tpu_torch.utils.metrics import METRICS

        restored = dropped = missing = 0
        with self._membership_lock:
            live = set(self.live)
        for table, meta in self.tables.items():
            want = {seg for seg, srvs in meta.ideal.items() if server.name in srvs}
            have = set(server.segment_names(table))
            for seg_name in sorted(have - want):
                server.drop_segment(table, seg_name)
                dropped += 1
            for seg_name in sorted(want - have):
                seg = None
                if self.deep_store is not None and self.deep_store.has_segment(table, seg_name):
                    try:
                        seg = server.restore_segment(table, seg_name, self.deep_store)
                    except Exception:  # noqa: BLE001 — fall through to a peer copy
                        METRICS.counter("coordinator.restoreFailures").inc()
                        log.exception(
                            "deep-store restore of %s/%s onto %s failed",
                            table, seg_name, server.name,
                        )
                if seg is None:
                    obj = self._find_segment_object(
                        table, seg_name, (meta.ideal.get(seg_name, set()) | live) - {server.name}
                    )
                    if obj is not None:
                        server.add_segment(table, obj)
                        seg = obj
                if seg is not None:
                    restored += 1
                else:
                    missing += 1
                    METRICS.counter("coordinator.segmentsUnrecoverable").inc()
                    log.error(
                        "segment %s/%s assigned to %s is in neither the deep store "
                        "nor any live replica", table, seg_name, server.name,
                    )
        if restored or dropped:
            METRICS.counter("coordinator.segmentsRestored").inc(restored)
            self._bump_version()
        return {"restored": restored, "dropped": dropped, "missing": missing}

    def mark_down(self, name: str) -> None:
        """Liveness loss (Helix session expiry analog): external view drops
        the server; ideal state keeps it until rebalance repairs."""
        self._require_leader()
        with self._membership_lock:
            was_live = name in self.live
            self.live.discard(name)
            if was_live:
                self.version += 1
        if was_live:
            # listeners run outside the lock: they take their own locks
            # (broker breaker reset) and must not order against membership
            self._notify_live(name, up=False)

    def mark_up(self, name: str) -> None:
        self._require_leader()
        with self._membership_lock:
            recovered = name in self.servers and name not in self.live
            if recovered:
                self.live.add(name)
                self.version += 1
        if recovered:
            self._notify_live(name, up=True)

    # -- server crash / restart (process-death simulation harness) --------
    def crash_server(self, name: str) -> None:
        """Kill a server: its in-memory/HBM segment state is LOST (the
        process died), and the external view drops it."""
        with self._membership_lock:
            server = self.servers.get(name)
        if server is not None:
            server.crash()
        self.mark_down(name)

    def restart_server(self, name: str) -> Dict[str, int]:
        """Restart a crashed server: reconcile its (empty) local state
        against ideal state — re-download committed segments from the deep
        store, re-pin to device — then rejoin the live set, which heals
        broker routing/breakers via the mark_up listener path."""
        with self._membership_lock:
            server = self.servers[name]
        server.boot()
        stats = self.reconcile_server(server)
        self.mark_up(name)
        return stats

    # -- table CRUD ------------------------------------------------------
    def add_table(self, schema: Schema, config: Optional[TableConfig] = None) -> None:
        self._require_leader()
        cfg = config or TableConfig(name=schema.name)
        if cfg.name in self.tables:
            raise ValueError(f"table {cfg.name} already exists")
        self._journal("add_table", table=cfg.name, schema=schema.to_dict(), config=cfg.to_dict())
        self.tables[cfg.name] = TableMeta(schema=schema, config=cfg)
        self._bump_version()

    def add_realtime_table(self, schema: Schema, config: TableConfig, data_dir: str, stream=None):
        """Create a REALTIME table owned by the cluster: the coordinator
        holds its RealtimeTableDataManager (the PinotLLCRealtimeSegmentManager
        slot — consuming-segment lifecycle lives here, not on a server) and
        the broker serves sealed + consuming segments from it."""
        from pinot_tpu_torch.realtime import RealtimeTableDataManager

        self._require_leader()
        if config.name in self.tables:
            raise ValueError(f"table {config.name} already exists")
        self._journal(
            "add_table",
            table=config.name,
            schema=schema.to_dict(),
            config=config.to_dict(),
            realtimeDataDir=data_dir,
        )
        self.tables[config.name] = TableMeta(schema=schema, config=config)
        self._rt_dirs[config.name] = data_dir
        self._bump_version()
        mgr = RealtimeTableDataManager(
            schema, config, data_dir, stream=stream, deep_store=self.deep_store
        )
        self._attach_realtime(config.name, mgr)
        return mgr

    def _attach_realtime(self, name: str, mgr) -> None:
        self.realtime[name] = mgr

        # checkpoint pointers are control-plane state: journal each commit
        # so a restored coordinator knows the committed (offset, seq) per
        # partition without touching the table's data dir
        def _on_checkpoint(partition: int, offset: int, seq: int, _t=name) -> None:
            self.rt_checkpoints.setdefault(_t, {})[int(partition)] = {
                "offset": int(offset), "seq": int(seq),
            }
            # "segSeq", not "seq": the journal reserves "seq" for its own
            # append ordering
            self._journal("rt_checkpoint", table=_t, partition=partition, offset=offset, segSeq=seq)

        mgr.on_checkpoint = _on_checkpoint

    def recover_realtime(self, name: str, stream=None):
        """Re-create a journaled realtime table's manager after coordinator
        restart.  The manager replays its own fsync'd checkpoint (sealed
        segments + committed offsets); `stream` re-binds the live source
        (memory streams can't be journaled — file/kafka-style configs
        rebuild from TableConfig alone)."""
        from pinot_tpu_torch.realtime import RealtimeTableDataManager

        if name in self.realtime:
            return self.realtime[name]
        meta = self.tables[name]
        data_dir = self._rt_dirs.get(name)
        if data_dir is None:
            raise KeyError(f"table {name!r} was not journaled as a realtime table")
        mgr = RealtimeTableDataManager(
            meta.schema, meta.config, data_dir, stream=stream, deep_store=self.deep_store
        )
        self._attach_realtime(name, mgr)
        self._bump_version()
        return mgr

    def run_realtime_consumption(self, max_batches: Optional[int] = None) -> int:
        """Step every realtime table's consume loops (the periodic driver the
        reference runs as per-partition consumer threads)."""
        total = 0
        for mgr in getattr(self, "realtime", {}).values():
            total += mgr.consume_all(max_batches=max_batches)
        return total

    def drop_table(self, name: str) -> None:
        self._require_leader()
        self._journal("drop_table", table=name)
        meta = self.tables.pop(name)
        self.realtime.pop(name, None)
        self._rt_dirs.pop(name, None)
        self._bump_version()
        with self._membership_lock:
            servers = dict(self.servers)
        for seg_name, assigned in meta.ideal.items():
            for s in assigned:
                if s in servers:
                    servers[s].drop_segment(name, seg_name)

    # -- segment registration + assignment -------------------------------
    def add_segment(self, table: str, segment: ImmutableSegment) -> List[str]:
        """addNewSegment -> assignSegment -> server state transitions.

        Durability ordering: segment data reaches the deep store FIRST,
        then the assignment journals, then servers load — a crash at any
        point leaves metadata that only ever references durable data, and
        restart reconciliation completes the placement."""
        self._require_leader()
        meta = self.tables[table]
        targets = self._assign(meta, segment.name)
        if self.deep_store is not None:
            self.deep_store.put_segment(table, segment)
        crash_point("coordinator.add_segment.after_upload")
        seg_meta = self._seg_meta(segment)
        self._journal(
            "set_ideal",
            table=table,
            segment=segment.name,
            servers=sorted(targets),
            meta=_jsonable(seg_meta),
        )
        crash_point("coordinator.add_segment.after_journal")
        meta.ideal[segment.name] = set(targets)
        meta.segment_meta[segment.name] = seg_meta
        self._bump_version()
        with self._membership_lock:
            servers = {s: self.servers[s] for s in targets}
        for s in targets:
            # device placement (HBM pins) happens outside the lock
            servers[s].add_segment(table, segment)
        return targets

    def _set_ideal(self, table: str, seg_name: str, servers: Set[str]) -> None:
        """Journal + apply one segment's new assignment (rebalance commit)."""
        self._journal("set_ideal", table=table, segment=seg_name, servers=sorted(servers))
        self.tables[table].ideal[seg_name] = set(servers)
        self._bump_version()

    def _seg_meta(self, segment: ImmutableSegment) -> Dict:
        part = None
        for c in segment.columns.values():
            if c.stats.partition_id is not None:
                part = (c.name, c.stats.partition_id, c.stats.num_partitions)
        # per-column stats for broker-side range injection (ZK segment
        # metadata analog: the broker never touches segment data)
        col_stats = {}
        for c in segment.columns.values():
            col_stats[c.name] = {
                "min": c.stats.min_value,
                "max": c.stats.max_value,
                "dictFp": c.dictionary.fingerprint() if c.has_dictionary else None,
            }
        from pinot_tpu_torch.cluster.server import _segment_bytes

        return {
            "numDocs": segment.num_docs,
            "timeRange": segment.time_range,
            "partition": part,
            "creationTimeMs": segment.creation_time_ms,
            "colStats": col_stats,
            # host-array residency: the broker's per-query cost estimator
            # sizes HBM working sets from this without touching segment data
            "bytes": _segment_bytes(segment),
        }

    def _assign(self, meta: TableMeta, seg_name: str) -> List[str]:
        """Replica-group aware balanced placement: one server per replica
        group (replication R = R groups), least-loaded within the group."""
        with self._membership_lock:
            live = set(self.live)
            groups = dict(self.replica_group)
        if not live:
            raise RuntimeError("no live servers to assign to")
        loads = {s: 0 for s in live}
        for segs in meta.ideal.values():
            for s in segs:
                if s in loads:
                    loads[s] += 1
        out: List[str] = []
        for g in range(self.num_replica_groups):
            members = [s for s in live if groups.get(s) == g]
            if not members:
                continue
            out.append(min(members, key=lambda s: (loads[s], s)))
        # a replica group with zero live members can't host its copy — top up
        # replication from the remaining live servers (availability over
        # strict group placement, like the reference's non-strict fallback)
        want = min(self.replication, len(live))
        remaining = [s for s in live if s not in out]
        while len(out) < want and remaining:
            pick = min(remaining, key=lambda s: (loads[s], s))
            remaining.remove(pick)
            out.append(pick)
        return out

    def mesh_placement(self, num_replica_rows: int) -> Dict[int, List[str]]:
        """Map the 2-D mesh's replica rows onto live servers: row r serves
        the replica groups congruent to r (mod num_replica_rows).  A derived
        view over replica_group/live — it tracks rebalances and failovers
        automatically, and CoordinatorHandle makes it HA-aware like every
        other Coordinator method.  An engine-side ReplicatedEngine consults
        this to skip rows whose backing servers are all dead."""
        rows = max(1, int(num_replica_rows))
        with self._membership_lock:
            live = set(self.live)
            groups = dict(self.replica_group)
        out: Dict[int, List[str]] = {r: [] for r in range(rows)}
        for server in sorted(live):
            out[groups.get(server, 0) % rows].append(server)
        return out

    # -- views -----------------------------------------------------------
    def external_view(self, table: str) -> Dict[str, Set[str]]:
        """Ideal state filtered to LIVE servers — what the broker routes on
        (ExternalView analog)."""
        meta = self.tables[table]
        with self._membership_lock:
            live = set(self.live)
        return {seg: {s for s in servers if s in live} for seg, servers in meta.ideal.items()}

    def versioned_view(self, table: str) -> Tuple[int, Dict[str, Set[str]]]:
        """(version, external view) — the version identifies which routing
        epoch a query's snapshot came from; rebalance/liveness transitions
        bump it, so two different answers are never attributed to one view."""
        meta = self.tables[table]
        with self._membership_lock:
            live = set(self.live)
            version = self.version
        view = {seg: {s for s in servers if s in live} for seg, servers in meta.ideal.items()}
        return version, view

    # -- rebalance --------------------------------------------------------
    def rebalance(self, table: str, min_available_replicas: int = 1) -> Dict[str, int]:
        """Live rebalance over the CURRENT live set (TableRebalancer.java
        :122-134 contract: load-before-drop, never below the availability
        floor, each move committed to the journal before old copies drop)."""
        from pinot_tpu_torch.cluster.rebalance import TableRebalancer

        self._require_leader()
        return TableRebalancer(self).rebalance(
            table, min_available_replicas=min_available_replicas
        )

    def _assign_for_rebalance(self, meta: TableMeta, seg_name: str) -> List[str]:
        return self._assign(meta, seg_name)

    def _find_segment_object(self, table: str, seg_name: str, candidates) -> Optional[ImmutableSegment]:
        with self._membership_lock:
            live = set(self.live)
            servers = dict(self.servers)
        for s in candidates:
            if s in live and s in servers:
                seg = servers[s].get_segment(table, seg_name)
                if seg is not None:
                    return seg
        return None

    # -- periodic tasks ---------------------------------------------------
    def run_retention(self, now_ms: Optional[int] = None) -> List[str]:
        """RetentionManager: drop segments whose time range fell out of the
        retention window."""
        self._require_leader()
        now_ms = now_ms or int(time.time() * 1000)
        with self._membership_lock:
            servers = dict(self.servers)
        purged: List[str] = []
        unit_ms = {"DAYS": 86_400_000, "HOURS": 3_600_000, "MINUTES": 60_000}
        for table, meta in self.tables.items():
            sc = meta.config.segments
            if sc.retention_time_value is None:
                continue
            horizon = now_ms - sc.retention_time_value * unit_ms.get(sc.retention_time_unit, 86_400_000)
            for seg_name in list(meta.ideal):
                tr = meta.segment_meta.get(seg_name, {}).get("timeRange")
                if tr is not None and tr[1] is not None and tr[1] < horizon:
                    self._journal("drop_segment", table=table, segment=seg_name)
                    for s in meta.ideal.pop(seg_name):
                        if s in servers:
                            servers[s].drop_segment(table, seg_name)
                    meta.segment_meta.pop(seg_name, None)
                    self._bump_version()
                    purged.append(f"{table}/{seg_name}")
        return purged

    # -- liveness (Helix session-expiry analog) ---------------------------
    def heartbeat(self, server_name: str) -> None:
        """Servers call this periodically; check_liveness marks stale ones
        down (the failure-DETECTION half of SURVEY §5.3 — rebalance is the
        recovery half).  Staleness is measured on the monotonic clock: an
        NTP step on the wall clock must never mass-expire the fleet."""
        self._require_leader()
        if not hasattr(self, "_heartbeats"):
            self._heartbeats: Dict[str, float] = {}
        self._heartbeats[server_name] = time.monotonic()
        # a recovered server resumes serving (Helix session re-establishment)
        with self._membership_lock:
            recovered = server_name in self.servers and server_name not in self.live
        if recovered:
            self.mark_up(server_name)

    def check_liveness(self, timeout_s: float = 30.0) -> List[str]:
        """Mark servers with stale heartbeats down; returns who was dropped."""
        now = time.monotonic()
        dropped = []
        with self._membership_lock:
            live = list(self.live)
        for name in live:
            hb = getattr(self, "_heartbeats", {}).get(name)
            if hb is not None and now - hb > timeout_s:
                self.mark_down(name)
                dropped.append(name)
        return dropped

    def run_periodic_tasks(self, heartbeat_timeout_s: float = 30.0) -> Dict[str, Any]:
        """One tick of the controller periodic-task set
        (ControllerPeriodicTask analog): liveness check, retention purge,
        realtime consumption step, auto-rebalance of tables with
        under-replicated segments, status report."""
        self._require_leader()
        dropped = self.check_liveness(heartbeat_timeout_s)
        purged = self.run_retention()
        consumed = self.run_realtime_consumption(max_batches=4)
        status = self.status_report()
        rebalanced = []
        with self._membership_lock:
            any_live = bool(self.live)
        for table, st in status.items():
            if st["underReplicated"] and any_live:
                self.rebalance(table)
                rebalanced.append(table)
        return {
            "serversDropped": dropped,
            "segmentsPurged": purged,
            "rowsConsumed": consumed,
            "tablesRebalanced": rebalanced,
        }

    def start_periodic_tasks(self, interval_s: float = 5.0, stop_event=None) -> "threading.Thread":
        """Background periodic-task thread (daemonized)."""
        from pinot_tpu_torch.utils.metrics import METRICS

        def loop():
            while stop_event is None or not stop_event.is_set():
                try:
                    self.run_periodic_tasks()
                except Exception:  # noqa: BLE001 — periodic tasks must not die
                    METRICS.counter("periodicTaskExceptions").inc()
                    log.exception("periodic task tick failed")
                time.sleep(interval_s)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t

    def status_report(self) -> Dict[str, Dict]:
        """SegmentStatusChecker: per-table replica health."""
        with self._membership_lock:
            live = set(self.live)
            servers = dict(self.servers)
        # per-server HBM reservation occupancy (admission ledger view)
        reserved = {}
        residency = {}
        for name, srv in servers.items():
            budget = getattr(srv, "budget", None)
            if budget is not None:
                reserved[name] = budget.snapshot()
            res = getattr(srv, "residency", None)
            if res is not None:
                # tiered-storage cache view: resident bytes, hit/miss/
                # eviction/prefetch counters per server
                residency[name] = res.snapshot()
        out: Dict[str, Dict] = {}
        for table, meta in self.tables.items():
            under = []
            for seg, seg_servers in meta.ideal.items():
                n_live = sum(1 for s in seg_servers if s in live)
                if n_live < min(self.replication, len(seg_servers)) or n_live == 0:
                    under.append(seg)
            out[table] = {
                "segments": len(meta.ideal),
                "underReplicated": under,
                "liveServers": sorted(live),
                "reservedBytes": reserved,
                "residency": residency,
            }
        return out
