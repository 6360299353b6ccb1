"""Coordinator metadata journal: fsync'd JSONL log + compacted snapshots.

Reference parity: the ZK property store under Helix — every ideal-state /
segment-metadata mutation the reference persists to ZooKeeper (and recovers
by reading back on controller restart) appends here instead.  The layout is
the classic WAL-plus-snapshot pair:

  {meta_dir}/journal.jsonl   one JSON object per line: {"seq": N, "op": ...}
  {meta_dir}/snapshot.json   {"seq": N, "state": {...}} — state after entry N

Append discipline: write line -> flush -> fsync (kill-point
`journal.append.after_write` sits between write and fsync, proving a torn
tail is recovered, not fatal).  Compaction writes the snapshot via
tmp-fsync-replace, then truncates the journal the same way — a crash
between the two replays already-snapshotted entries, which every `op`
handler tolerates by being idempotent (set-valued ideal state, last-writer
checkpoint pointers).

Recovery tolerates exactly the artifacts crashes produce: a truncated final
journal line is dropped AND truncated off the file (it never committed — its
fsync didn't return; cutting the partial bytes means a later append can
never concatenate onto them into one garbled line); a corrupt snapshot is
quarantined aside (`.corrupt-N`) and the previous snapshot
(`snapshot.json.bak`) or empty state is used; stale `*.tmp` files are swept.

Port of pinot_tpu/cluster/journal.py (host only).  The file formats are
byte-compatible with the JAX package's journal: either package restores a
meta_dir the other wrote.

The EPOCH FENCE (cluster/election.py): when a LeaseManager is
attached as `self.fence`, every append re-validates the durable lease under
the journal lock and stamps the entry with the writer's epoch; an append
from a deposed epoch raises FencedEpochError before any byte reaches the
log (counter `coordinator.fencedAppends`), and replay drops any
epoch-regressed interleaving a torn race still managed to leave behind.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.cluster.election import NotLeaderError
from pinot_tpu_torch.spi.filesystem import durable_write_json, fsync_dir, sweep_tmp
from pinot_tpu_torch.utils.crashpoints import crash_point
from pinot_tpu_torch.utils.metrics import METRICS

log = logging.getLogger("pinot_tpu_torch.cluster")

JOURNAL_FILE = "journal.jsonl"
SNAPSHOT_FILE = "snapshot.json"


def _quarantine(path: str) -> Optional[str]:
    """Rename a corrupt file aside (never delete evidence); returns the new
    path or None if the rename itself failed."""
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


class MetaJournal:
    """Append-ordered durable log of coordinator state mutations."""

    def __init__(self, meta_dir: str, compact_every: int = 256):
        self.meta_dir = meta_dir
        self.compact_every = max(1, int(compact_every))
        os.makedirs(meta_dir, exist_ok=True)
        sweep_tmp(meta_dir)
        self._lock = threading.Lock()
        self._fh = None  # lazily (re)opened append handle
        self.seq = 0  # last durably appended entry seq
        self.appended_since_snapshot = 0
        # LeaseManager epoch fence (cluster/election.py); None = unfenced
        # (a coordinator without an election, or legacy callers)
        self.fence = None
        # FaultPlan hook for the journal_append_latency rule
        self.fault_plan = None

    # -- paths -----------------------------------------------------------
    @property
    def journal_path(self) -> str:
        return os.path.join(self.meta_dir, JOURNAL_FILE)

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.meta_dir, SNAPSHOT_FILE)

    # -- append ----------------------------------------------------------
    def append(self, op: str, **data: Any) -> int:
        """Durably append one mutation; returns its seq.  The entry is
        committed once fsync returns — a crash before that point loses (at
        most) a torn final line, which load() drops."""
        with self._lock:
            plan = self.fault_plan
            if plan is not None:
                plan.on_journal_append(
                    self.fence.node_id if self.fence is not None else "journal"
                )
            epoch = 0
            if self.fence is not None:
                try:
                    epoch = self.fence.validate_writer()
                except NotLeaderError:
                    # a deposed writer: refuse BEFORE any byte hits the log
                    # (seq untouched — the entry never existed)
                    METRICS.counter("coordinator.fencedAppends").inc()
                    raise
            self.seq += 1
            # reserved keys win: an op payload must never clobber the
            # journal's own sequencing/fencing fields
            entry = dict(data)
            entry["seq"] = self.seq
            entry["op"] = op
            if self.fence is not None:
                entry["epoch"] = epoch
            line = json.dumps(entry, separators=(",", ":")) + "\n"
            if self._fh is None:
                self._fh = open(self.journal_path, "a", encoding="utf-8")
            self._fh.write(line)
            crash_point("journal.append.after_write")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appended_since_snapshot += 1
            METRICS.counter("coordinator.journalAppends").inc()
            return self.seq

    def should_compact(self) -> bool:
        with self._lock:
            return self.appended_since_snapshot >= self.compact_every

    # -- snapshot / compaction -------------------------------------------
    def snapshot(self, state: Dict[str, Any]) -> None:
        """Write a compacted snapshot of `state` (which must reflect every
        entry up to self.seq), then truncate the journal.  Crash-ordering:
        snapshot commits BEFORE the journal truncates, so a crash between
        the two only re-applies idempotent entries on the next load."""
        with self._lock:
            seq = self.seq
            # keep the previous snapshot as the corruption fallback
            if os.path.exists(self.snapshot_path):
                os.replace(self.snapshot_path, self.snapshot_path + ".bak")
            crash_point("journal.snapshot.after_bak")
            durable_write_json(
                self.snapshot_path,
                {"seq": seq, "state": state},
                crash_prefix="journal.snapshot",
            )
            crash_point("journal.snapshot.before_truncate")
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            tmp = self.journal_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.journal_path)
            fsync_dir(self.meta_dir)
            self.appended_since_snapshot = 0
            METRICS.counter("coordinator.journalCompactions").inc()

    # -- load ------------------------------------------------------------
    def load(self) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """Read (snapshot_state, entries-after-snapshot) from disk,
        recovering from every crash artifact the commit paths can produce.
        Also positions self.seq after the last committed entry so appends
        continue the sequence."""
        with self._lock:
            sweep_tmp(self.meta_dir)
            state, snap_seq = self._load_snapshot_locked()
            entries = self._load_journal_locked(after_seq=snap_seq)
            self.seq = max(snap_seq, entries[-1]["seq"] if entries else 0)
            self.appended_since_snapshot = len(entries)
            return state, entries

    def _load_snapshot_locked(self) -> Tuple[Optional[Dict[str, Any]], int]:
        for path in (self.snapshot_path, self.snapshot_path + ".bak"):
            if not os.path.exists(path):
                continue
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                return doc.get("state") or {}, int(doc.get("seq", 0))
            except (json.JSONDecodeError, OSError, ValueError, TypeError) as e:
                METRICS.counter("coordinator.snapshotCorrupt").inc()
                aside = _quarantine(path)
                log.warning(
                    "corrupt coordinator snapshot %s (%s) quarantined to %s", path, e, aside
                )
        return None, 0

    def _load_journal_locked(self, after_seq: int) -> List[Dict[str, Any]]:
        path = self.journal_path
        if not os.path.exists(path):
            return []
        entries: List[Dict[str, Any]] = []
        raw_lines: List[Tuple[int, bytes]] = []  # (byte offset, raw line)
        with open(path, "rb") as f:
            off = 0
            for raw in iter(f.readline, b""):
                raw_lines.append((off, raw))
                off += len(raw)
        last_seq = after_seq
        max_epoch = 0
        for i, (off, raw) in enumerate(raw_lines):
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
                seq = int(entry["seq"])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                if i == len(raw_lines) - 1 or not raw.endswith(b"\n"):
                    # torn final line: the append died before fsync — that
                    # entry never committed.  Drop it AND cut the partial
                    # bytes off the file, so the next append starts a fresh
                    # line instead of concatenating into garbage
                    METRICS.counter("coordinator.journalTornTail").inc()
                    log.warning("truncating torn journal tail line in %s", path)
                    self._truncate_at_locked(off)
                    break
                # mid-file corruption: quarantine the whole log; committed
                # state up to the snapshot survives
                METRICS.counter("coordinator.journalCorrupt").inc()
                aside = _quarantine(path)
                log.error("corrupt journal %s quarantined to %s", path, aside)
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                return entries
            if seq <= last_seq:
                continue  # replay overlap after a crash mid-compaction
            epoch = int(entry.get("epoch", 0) or 0)
            if epoch < max_epoch:
                # interleaving from a deposed epoch (belt to the append
                # fence's suspenders): replay ignores it
                METRICS.counter("coordinator.fencedReplayDropped").inc()
                continue
            if epoch > max_epoch:
                max_epoch = epoch
            last_seq = seq
            entries.append(entry)
        return entries

    def _truncate_at_locked(self, offset: int) -> None:
        """Cut the journal back to `offset` (torn-tail recovery).  Best
        effort: a failure here just leaves the torn tail in place (the torn
        line stays on disk and keeps being dropped at every load)."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        try:
            with open(self.journal_path, "r+b") as f:
                f.truncate(offset)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            log.exception("could not truncate torn journal tail in %s", self.journal_path)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
