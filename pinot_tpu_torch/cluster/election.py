"""Lease-based coordinator leadership: durable lease, fenced epochs, failover.

Reference parity: the controller leader election Pinot delegates to Helix
(ZooKeeper ephemeral-node leadership + the cluster's epoch'd external view).
Re-design for the ZK-free control plane: leadership is a DURABLE LEASE FILE
in the coordinator's meta_dir ({meta_dir}/lease.json, written with the same
tmp-fsync-replace discipline as every other durability artifact) carrying a
monotonically increasing **epoch** — the fencing token.  Taurus (PAPERS.md,
"Near Data Processing in Taurus Database") makes the same move: the durable
log IS the database, and availability comes from fencing who may write it,
not from any process staying up.

The pieces:

  * LeaseManager — acquire/renew/release over the lease file on an
    INJECTABLE clock (tests and the smoke script drive a simulated clock;
    lease code never does wall-clock arithmetic).  Every acquisition bumps
    the epoch; a polite acquire refuses an unexpired lease held by another
    node, while the boot-time force acquire models the operator restarting a
    coordinator over its own meta_dir (the restart FENCES the zombie: the
    old in-memory object keeps a stale epoch and can no longer commit).
  * The epoch fence — cluster/journal.py stamps every append with the
    writer's epoch and calls LeaseManager.validate_writer() under the
    journal lock: when the durable lease has moved past the writer's epoch,
    the append raises FencedEpochError BEFORE any byte reaches the log.  A
    GC-paused leader that wakes past lease expiry can therefore not commit,
    and replay additionally drops any epoch-regressed interleaving.
  * JournalFollower — a standby coordinator's read-only incremental view of
    the leader's journal, riding the shared spi.filesystem.TailFollower
    (byte-offset memo + torn-tail park, the same follower FileStream ingest
    tails with).  Compactions (journal truncations) resynchronize from the
    snapshot.  The standby never writes or sweeps the leader's directory.
  * CoordinatorHandle — what brokers and servers hold INSTEAD of a raw
    Coordinator.  Attribute reads delegate to the current leader (falling
    back to the last known leader's versioned routing view during a
    failover, so the data plane keeps serving); control-plane method calls
    catch NotLeaderError, re-resolve leadership with bounded jittered
    retries, park bounded (reserve_or_wait-style) while a standby takes
    over, and re-register live-change listeners and server instances on the
    new leader.

Split-brain determinism: two standbys racing an expired lease both bump to
the same epoch; the one whose durable write lost discovers the foreign
holder at its next fence check and demotes — the journal never interleaves
epochs (tests/test_torch_election.py holds this under the kill-point
harness).

Port of pinot_tpu/cluster/election.py (host only).
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from pinot_tpu_torch.utils import threads
from pinot_tpu_torch.spi.filesystem import TailFollower, durable_write_json, sweep_tmp
from pinot_tpu_torch.utils.crashpoints import crash_point
from pinot_tpu_torch.utils.metrics import METRICS

log = logging.getLogger("pinot_tpu_torch.cluster")

LEASE_FILE = "lease.json"


class NotLeaderError(RuntimeError):
    """A control-plane mutation reached a coordinator that is not the
    current leader (standby, paused, or deposed).  CoordinatorHandle
    catches this, re-resolves leadership, and retries bounded."""

    def __init__(self, message: str, leader_hint: Optional[str] = None):
        super().__init__(message)
        self.leader_hint = leader_hint


class FencedEpochError(NotLeaderError):
    """The epoch fence tripped: the durable lease moved past this writer's
    epoch, so its journal append was REFUSED before any byte hit the log.
    Subclasses NotLeaderError so the handle's failover retry covers it."""

    def __init__(self, node: str, epoch: int, lease_epoch: int, holder: str):
        super().__init__(
            f"journal append fenced: {node} holds epoch {epoch} but the lease "
            f"moved to {holder!r} at epoch {lease_epoch}",
            leader_hint=holder,
        )
        self.node = node
        self.epoch = epoch
        self.lease_epoch = lease_epoch
        self.holder = holder


@dataclass(frozen=True)
class Lease:
    holder: str
    epoch: int
    expires_at: float
    acquired_at: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "holder": self.holder,
            "epoch": self.epoch,
            "expiresAt": self.expires_at,
            "acquiredAt": self.acquired_at,
        }


def _quarantine(path: str) -> Optional[str]:
    """Rename a corrupt file aside (never delete evidence)."""
    for i in range(1000):
        aside = f"{path}.corrupt-{i}"
        if not os.path.exists(aside):
            try:
                os.replace(path, aside)
                return aside
            except OSError:
                log.exception("could not quarantine corrupt file %s", path)
                return None
    return None


class LeaseManager:
    """The durable lease over one meta_dir.

    Clock discipline: `clock` is injectable and defaults to time.monotonic —
    lease deadlines and expiry comparisons NEVER touch the wall clock (an
    NTP step must not depose a healthy leader or immortalize a dead one).  Production deployments with separate
    hosts would fold bounded clock skew into the TTL margin; the FaultPlan
    lease_clock_skew rule models exactly that."""

    def __init__(
        self,
        meta_dir: str,
        node_id: str,
        ttl_s: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.meta_dir = meta_dir
        self.node_id = node_id
        self.ttl_s = float(
            os.environ.get("PINOT_TPU_LEASE_TTL_S", "5") if ttl_s is None else ttl_s
        )
        self.clock = clock or time.monotonic
        # cluster/faults.py hooks: renew suppression (leader-pause) and
        # per-node clock skew ride the plan when one is attached
        self.fault_plan = None
        self.epoch = 0  # the epoch THIS node last held (0 = never led)
        self.is_leader = False
        self._lock = threads.Lock()
        os.makedirs(meta_dir, exist_ok=True)

    @property
    def lease_path(self) -> str:
        return os.path.join(self.meta_dir, LEASE_FILE)

    def now(self) -> float:
        """This node's view of cluster time: the injectable clock plus any
        fault-injected skew (lease_clock_skew rule)."""
        t = self.clock()
        plan = self.fault_plan
        if plan is not None:
            t += plan.lease_skew_ms(self.node_id) / 1000.0
        return t

    def sweep_stale_tmp(self) -> List[str]:
        """Sweep the lease/meta dir of stale `*.tmp` artifacts a crash
        mid-acquire left behind — a lease.json.tmp is by definition an
        UNCOMMITTED acquisition and must never be mistaken for a live
        lease.  Runs on coordinator boot and on standby promote."""
        swept = sweep_tmp(self.meta_dir)
        stale = [p for p in swept if os.path.basename(p).startswith(LEASE_FILE)]
        if stale:
            METRICS.counter("coordinator.staleLeaseTmpSwept").inc(len(stale))
            log.warning("swept stale lease tmp artifacts: %s", stale)
        return swept

    def read(self) -> Optional[Lease]:
        """The durable lease as committed on disk (None when absent; a
        corrupt lease quarantines aside and reads as absent — an unreadable
        lease must not wedge the election forever)."""
        path = self.lease_path
        if not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            return Lease(
                holder=str(doc["holder"]),
                epoch=int(doc["epoch"]),
                expires_at=float(doc["expiresAt"]),
                acquired_at=float(doc["acquiredAt"]),
            )
        except (json.JSONDecodeError, OSError, KeyError, TypeError, ValueError) as e:
            METRICS.counter("coordinator.leaseCorrupt").inc()
            aside = _quarantine(path)
            log.warning("corrupt lease %s (%s) quarantined to %s", path, e, aside)
            return None

    def _write(self, lease: Lease, crash_prefix: str) -> None:
        durable_write_json(self.lease_path, lease.to_dict(), crash_prefix=crash_prefix)

    def try_acquire(self, force: bool = False) -> bool:
        """Acquire leadership, bumping the epoch.  Polite by default: an
        unexpired lease held by another node refuses.  `force=True` is the
        boot-time takeover — a coordinator (re)started over its meta_dir
        claims the directory and fences any zombie still holding the old
        epoch in memory."""
        with self._lock:
            cur = self.read()
            crash_point("election.acquire.after_read")
            now = self.now()
            if (
                cur is not None
                and cur.holder != self.node_id
                and not force
                and cur.expires_at > now
            ):
                return False
            epoch = (cur.epoch if cur is not None else 0) + 1
            self._write(
                Lease(self.node_id, epoch, now + self.ttl_s, now),
                crash_prefix="election.acquire",
            )
            self.epoch = epoch
            self.is_leader = True
            METRICS.counter("coordinator.leaderElections").inc()
            METRICS.gauge("coordinator.epoch").set(epoch)
            return True

    def renew(self) -> bool:
        """Extend the held lease.  Returns False when leadership is LOST
        (the durable lease moved past this node's epoch) — the caller must
        demote.  A FaultPlan leader-pause suppresses the renewal entirely
        (the frozen process never runs it), returning True unchanged: the
        danger of that lie is exactly what the epoch fence catches."""
        with self._lock:
            if not self.is_leader:
                return False
            plan = self.fault_plan
            if plan is not None and not plan.allow_lease_renew(self.node_id):
                return True  # frozen: the renewal simply never happened
            cur = self.read()
            if cur is None or cur.holder != self.node_id or cur.epoch != self.epoch:
                self.is_leader = False
                METRICS.counter("coordinator.leadershipLost").inc()
                return False
            now = self.now()
            # the write itself carries the kill-points (election.renew
            # .after_write / .after_replace) — no extra point here, a
            # duplicate name would fire inside the write instead
            self._write(
                Lease(self.node_id, self.epoch, now + self.ttl_s, cur.acquired_at),
                crash_prefix="election.renew",
            )
            METRICS.counter("coordinator.leaseRenewals").inc()
            return True

    def release(self) -> None:
        """Voluntary step-down: expire the held lease NOW so a standby can
        take over without waiting out the TTL."""
        with self._lock:
            if not self.is_leader:
                return
            cur = self.read()
            if cur is not None and cur.holder == self.node_id and cur.epoch == self.epoch:
                self._write(
                    Lease(self.node_id, self.epoch, self.now(), cur.acquired_at),
                    crash_prefix="election.release",
                )
            self.is_leader = False

    def expired(self) -> bool:
        """Whether the durable lease is absent or past expiry on this
        node's clock (the standby's promotion predicate)."""
        cur = self.read()
        return cur is None or cur.expires_at <= self.now()

    # -- the epoch fence (called by MetaJournal.append under ITS lock) ----
    def validate_writer(self) -> int:
        """Refuse the write when the durable lease moved past this node's
        epoch; returns the epoch to stamp on the entry otherwise.  Note the
        epoch-EQUAL-but-foreign-holder case: two racing acquisitions of an
        expired lease both bump to N+1, and the loser (whose durable write
        was overwritten) discovers the foreign holder here."""
        crash_point("journal.append.before_fence")
        with self._lock:
            if not self.is_leader:
                raise NotLeaderError(f"{self.node_id} is not the leader")
            cur = self.read()
            if cur is not None and (
                cur.epoch > self.epoch
                or (cur.epoch == self.epoch and cur.holder != self.node_id)
            ):
                self.is_leader = False
                raise FencedEpochError(self.node_id, self.epoch, cur.epoch, cur.holder)
            epoch = self.epoch
        crash_point("journal.append.after_fence")
        return epoch

    def snapshot(self) -> Dict[str, Any]:
        lease = self.read()
        with self._lock:
            epoch, is_leader = self.epoch, self.is_leader
        return {
            "node": self.node_id,
            "epoch": epoch,
            "isLeader": is_leader,
            "ttl_s": self.ttl_s,
            "lease": None
            if lease is None
            else {
                "holder": lease.holder,
                "epoch": lease.epoch,
                "expiresIn_s": round(lease.expires_at - self.now(), 3),
            },
        }


class JournalFollower:
    """A standby coordinator's read-only incremental view of the leader's
    journal: snapshot bootstrap/resync + TailFollower over journal.jsonl.
    Never writes, never sweeps, never quarantines — the directory belongs
    to the leader; a torn tail parks (it may be an append IN FLIGHT)."""

    def __init__(self, meta_dir: str):
        from pinot_tpu_torch.cluster.journal import JOURNAL_FILE, SNAPSHOT_FILE

        self.meta_dir = meta_dir
        self._snapshot_path = os.path.join(meta_dir, SNAPSHOT_FILE)
        self._tail = TailFollower(os.path.join(meta_dir, JOURNAL_FILE))
        self.last_seq = 0
        self.max_epoch = 0

    def _read_snapshot(self) -> Tuple[Optional[Dict[str, Any]], int]:
        for path in (self._snapshot_path, self._snapshot_path + ".bak"):
            if not os.path.exists(path):
                continue
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                return doc.get("state") or {}, int(doc.get("seq", 0))
            except (json.JSONDecodeError, OSError, ValueError, TypeError):
                # mid-compaction read or corruption: the leader's own load()
                # quarantines on restart — a follower just tries the .bak
                METRICS.counter("coordinator.standbySnapshotRetries").inc()
        return None, 0

    def bootstrap(self) -> Optional[Dict[str, Any]]:
        """Initial sync: position after the snapshot (if any) and return its
        state for the standby to apply before the first poll()."""
        state, snap_seq = self._read_snapshot()
        self.last_seq = snap_seq
        return state

    def poll(self) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """Pull newly committed entries.  Returns (resync_state, entries):
        `resync_state` is non-None when the journal was truncated under the
        follower (a leader compaction) — the caller must RESET to that
        snapshot state before applying the entries."""
        lines, _next, _eof, truncated = self._tail.read()
        state: Optional[Dict[str, Any]] = None
        if truncated:
            state, snap_seq = self._read_snapshot()
            state = state or {}
            self.last_seq = snap_seq
            self.max_epoch = 0  # epochs re-ratchet over the fresh tail
            # the shrink read reset the tail without surfacing lines:
            # re-read from the top so post-compaction entries apply NOW
            lines, _next, _eof, _tr = self._tail.read()
        entries: List[Dict[str, Any]] = []
        for _i, text in lines:
            text = text.strip()
            if not text:
                continue
            try:
                entry = json.loads(text)
                seq = int(entry["seq"])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                # a complete-but-unparseable line mid-journal: skip it and
                # count — the leader's restart load() owns quarantining
                METRICS.counter("coordinator.standbyJournalSkips").inc()
                continue
            if seq <= self.last_seq:
                continue  # already applied (snapshot overlap after resync)
            epoch = int(entry.get("epoch", 0) or 0)
            if epoch < self.max_epoch:
                # torn interleaving from a deposed epoch: replay ignores it
                METRICS.counter("coordinator.fencedReplayDropped").inc()
                continue
            if epoch > self.max_epoch:
                self.max_epoch = epoch
            self.last_seq = seq
            entries.append(entry)
        return state, entries


def _park_env_ms() -> float:
    return float(os.environ.get("PINOT_TPU_FAILOVER_PARK_MS", "10000"))


def _retries_env() -> int:
    return int(os.environ.get("PINOT_TPU_FAILOVER_RETRIES", "8"))


class CoordinatorHandle:
    """Leadership-aware facade brokers and servers hold instead of a raw
    Coordinator.

    Delegation contract:
      * attribute READS (`handle.tables`, `handle.live`, ...) resolve
        against the current leader, falling back to the LAST KNOWN leader
        during a failover window — the data plane keeps serving off that
        object's versioned routing view while control-plane leadership
        moves;
      * METHOD calls route to the current leader and, on NotLeaderError
        (standby hit, paused leader, epoch fence), re-resolve with bounded
        jittered retries and a bounded reserve_or_wait-style park while a
        standby takes over (run_election_tick is driven on every candidate
        during the park, so a single-threaded caller still converges);
      * on_live_change listeners and register_server instances are RECORDED
        and re-registered on every newly adopted leader, so breaker-heal
        wiring and membership survive the failover without any caller
        changes.
    """

    _INTERNAL = frozenset(
        {
            "_candidates",
            "_lock",
            "_last",
            "_adopted",
            "_listeners",
            "_servers",
            "_sleep",
            "_clock",
            "_rng",
            "park_ms",
            "retries",
            "auto_tick",
        }
    )

    # methods that are pure control-plane READS: they never park or retry —
    # during a failover they serve off the last known leader's versioned
    # view, exactly like the attribute-read path (the data plane must not
    # stall behind an election)
    _READ_METHODS = frozenset(
        {
            "external_view",
            "versioned_view",
            "_find_segment_object",
            "status_report",
            "election_state",
        }
    )

    def __init__(
        self,
        candidates,
        park_ms: Optional[float] = None,
        retries: Optional[int] = None,
        sleep: Optional[Callable[[float], None]] = None,
        clock: Optional[Callable[[], float]] = None,
        auto_tick: bool = True,
    ):
        if not candidates:
            raise ValueError("CoordinatorHandle needs at least one coordinator")
        self._candidates = list(candidates)
        self._lock = threads.RLock()
        self._last = None  # last adopted leader: the data-plane read fallback
        self._adopted: set = set()  # id()s of leaders already re-wired
        self._listeners: List[Any] = []  # on_live_change fns to re-register
        self._servers: Dict[str, Any] = {}  # name -> instance to re-register
        self._sleep = sleep or time.sleep
        self._clock = clock or time.monotonic
        self.park_ms = _park_env_ms() if park_ms is None else float(park_ms)
        self.retries = _retries_env() if retries is None else int(retries)
        self.auto_tick = auto_tick
        self._rng = random.Random(0x1EADE12)
        # adopt the boot-time leader so reads have a fallback from the start
        self.current()

    @classmethod
    def wrap(cls, coordinator) -> "CoordinatorHandle":
        """Idempotent: an existing handle passes through; a raw Coordinator
        becomes a single-candidate handle (standbys join via
        add_candidate)."""
        if isinstance(coordinator, CoordinatorHandle):
            return coordinator
        return cls([coordinator])

    def add_candidate(self, coordinator) -> "CoordinatorHandle":
        with self._lock:
            if coordinator not in self._candidates:
                self._candidates.append(coordinator)
        return self

    # -- resolution -------------------------------------------------------
    def _find_leader(self):
        with self._lock:
            cands = list(self._candidates)
        for c in cands:
            if getattr(c, "role", "leader") == "leader" and not getattr(c, "_paused", False):
                return c
        return None

    def current(self):
        """The current leader, adopting it (listener + server
        re-registration) when it changed — or None during a blackout."""
        leader = self._find_leader()
        if leader is None:
            return None
        with self._lock:
            if leader is not self._last:
                if id(leader) not in self._adopted:
                    self._adopt_locked(leader)
                    self._adopted.add(id(leader))
                self._last = leader
        return leader

    def _adopt_locked(self, leader) -> None:
        """Re-wire a newly resolved leader: servers re-register (idempotent
        — replayed membership reconciles, it does not re-journal) and
        live-change listeners re-subscribe, so broker breaker-heal paths
        keep working across the failover."""
        for server in list(self._servers.values()):
            try:
                leader.register_server(server)
            except Exception:  # noqa: BLE001 — adoption must not wedge resolution
                METRICS.counter("coordinator.handleAdoptErrors").inc()
                log.exception(
                    "re-registering server %s on new leader failed",
                    getattr(server, "name", "?"),
                )
        for fn in list(self._listeners):
            leader.on_live_change(fn)
        METRICS.counter("coordinator.handleLeadersAdopted").inc()

    def _current_for_read(self):
        leader = self.current()
        if leader is not None:
            return leader
        with self._lock:
            if self._last is not None:
                return self._last  # failover window: serve off the last routing view
            return self._candidates[0]

    # -- recorded registrations (re-played onto every new leader) ---------
    def on_live_change(self, fn) -> None:
        with self._lock:
            self._listeners.append(fn)
        # already adopted leaders got their listeners in _adopt_locked only
        # if registered before; register explicitly on the current one
        cur = self.current()
        if cur is not None:
            cur.on_live_change(fn)

    def register_server(self, server) -> None:
        with self._lock:
            self._servers[server.name] = server
        self._call("register_server", (server,), {})

    # -- failover-aware method dispatch -----------------------------------
    def _backoff_s(self, attempt: int) -> float:
        base = 0.005 * (2 ** min(attempt, 6))
        return base * (0.5 + self._rng.random())

    def _park_for_leader(self, deadline: float):
        """reserve_or_wait-style bounded park: a control-plane write waits a
        bounded window for a standby to take over instead of failing fast.
        Candidates' election ticks are driven here so a single-threaded
        process still converges (the standby promotes once the lease
        expires on the shared clock)."""
        attempt = 0
        while True:
            if self.auto_tick:
                with self._lock:
                    cands = list(self._candidates)
                for c in cands:
                    tick = getattr(c, "run_election_tick", None)
                    if tick is None:
                        continue
                    try:
                        tick()
                    except Exception:  # noqa: BLE001 — a sick candidate must not block the park
                        METRICS.counter("coordinator.handleTickErrors").inc()
                        log.exception("election tick failed during failover park")
            leader = self.current()
            if leader is not None:
                METRICS.counter("coordinator.failoverParksServed").inc()
                return leader
            if self._clock() >= deadline:
                METRICS.counter("coordinator.failoverParkTimeouts").inc()
                raise NotLeaderError(
                    "no coordinator leader within the failover park window"
                )
            attempt += 1
            self._sleep(self._backoff_s(attempt))

    def _call(self, name: str, args: tuple, kwargs: dict):
        deadline = self._clock() + self.park_ms / 1000.0
        attempt = 0
        while True:
            target = self.current()
            if target is None:
                target = self._park_for_leader(deadline)
            try:
                return getattr(target, name)(*args, **kwargs)
            except NotLeaderError:
                METRICS.counter("coordinator.notLeaderRetries").inc()
                attempt += 1
                if attempt > self.retries or self._clock() >= deadline:
                    raise
                # bounded jittered backoff before re-resolving (the data
                # plane's retry discipline, applied to the control plane)
                self._sleep(self._backoff_s(attempt))

    def election_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            cands = list(self._candidates)
        leader = self._find_leader()
        return {
            "leader": getattr(leader, "node_id", None) if leader is not None else None,
            "candidates": [c.election_state() for c in cands],
        }

    # -- transparent delegation ------------------------------------------
    def __getattr__(self, name: str):
        if name.startswith("__") or name in CoordinatorHandle._INTERNAL:
            raise AttributeError(name)
        target = self._current_for_read()
        val = getattr(target, name)
        if callable(val):
            if name in CoordinatorHandle._READ_METHODS:
                def _read_call(*args, __name=name, **kwargs):
                    return getattr(self._current_for_read(), __name)(*args, **kwargs)

                _read_call.__name__ = name
                return _read_call

            def _failover_call(*args, __name=name, **kwargs):
                return self._call(__name, args, kwargs)

            _failover_call.__name__ = name
            return _failover_call
        return val
