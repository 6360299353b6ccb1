"""TableRebalancer: live segment moves under query load.

Reference parity: TableRebalancer.rebalance (pinot-controller/.../rebalance/
TableRebalancer.java:201) and its availability contract (:122-134): during a
move a segment NEVER has fewer than `min_available_replicas` live serving
copies.  The mechanism is load-before-drop with a committed intermediate
state:

  1. LOAD  — every newly-desired replica materializes the segment (from a
             live peer's copy, or re-downloaded + CRC-verified from the
             deep store) and starts serving it;
  2. COMMIT — the new ideal state is journaled (fsync'd) and the routing
             view version bumps, so a coordinator crash on either side of
             the commit resolves to a consistent assignment on restart
             (before: old ideal, extra copies reconciled away; after: new
             ideal, stale copies reconciled away);
  3. DROP  — old replicas release only while the live copies among the
             committed assignment stay at or above the availability floor.

Kill-points `rebalance.after_add` and `rebalance.after_commit` sit between
the steps so the crash harness proves the ordering, and queries running
concurrently route on a consistent per-query snapshot of the view.

Port of pinot_tpu/cluster/rebalance.py (host only).  A peer's segment
object is shared, never reloaded, so a moved replica costs no second copy
on the card.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set

from pinot_tpu_torch.utils.crashpoints import crash_point
from pinot_tpu_torch.utils.metrics import METRICS

log = logging.getLogger("pinot_tpu_torch.cluster")


class TableRebalancer:
    def __init__(self, coordinator):
        self.coordinator = coordinator

    def rebalance(self, table: str, min_available_replicas: int = 1) -> Dict[str, int]:
        """Repair/redistribute `table`'s assignment over the CURRENT live
        set, one segment move at a time (each move independently satisfies
        the availability floor, so queries interleave safely)."""
        coord = self.coordinator
        meta = coord.tables[table]
        moved = added = dropped = 0
        for seg_name in list(meta.ideal):
            with coord._membership_lock:
                live = set(coord.live)
                servers = dict(coord.servers)
            current = set(meta.ideal.get(seg_name, ()))
            desired = set(coord._assign_for_rebalance(meta, seg_name))
            if desired == current:
                continue
            # -- 1. LOAD: materialize every new replica before anything drops
            placed: Set[str] = set()
            for s in sorted(desired - current):
                if self._materialize(table, seg_name, servers.get(s), current | live):
                    placed.add(s)
                    added += 1
            if (desired - current) - placed:
                # a target could not load the segment (no live copy, no deep
                # store): commit only the part of the move that materialized
                desired = (desired & current) | placed
                if desired == current:
                    continue
            crash_point("rebalance.after_add")
            # -- 2. COMMIT: availability floor decides whether old copies
            # may drop; the surviving assignment is journaled BEFORE drops
            survivors = {s for s in desired if s in live}
            if len(survivors) >= min_available_replicas:
                final = set(desired)
            else:
                final = set(desired) | current  # floor: keep the old copies
            coord._set_ideal(table, seg_name, final)
            crash_point("rebalance.after_commit")
            # -- 3. DROP: stale replicas release after the committed view
            # stopped routing to them
            for s in sorted(current - final):
                if s in servers:
                    servers[s].drop_segment(table, seg_name)
                    dropped += 1
            moved += 1
            METRICS.counter("coordinator.segmentsMoved").inc()
        return {"segmentsMoved": moved, "replicasAdded": added, "replicasDropped": dropped}

    def _materialize(self, table: str, seg_name: str, server, candidates) -> bool:
        """Make `server` serve the segment: share a live peer's object, or
        restore a CRC-verified copy from the deep store."""
        if server is None:
            return False
        if server.get_segment(table, seg_name) is not None:
            return True
        coord = self.coordinator
        segment = coord._find_segment_object(table, seg_name, candidates)
        if segment is not None:
            server.add_segment(table, segment)
            return True
        ds = coord.deep_store
        if ds is not None and ds.has_segment(table, seg_name):
            try:
                server.restore_segment(table, seg_name, ds)
                return True
            except Exception:  # noqa: BLE001 — a failed restore just skips this target
                METRICS.counter("coordinator.rebalanceRestoreFailures").inc()
                log.exception(
                    "rebalance: restoring %s/%s onto %s failed", table, seg_name, server.name
                )
        return False
