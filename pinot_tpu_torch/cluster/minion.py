"""Minion tasks: merge/rollup, purge, realtime-to-offline.

Reference parity: the minion framework (PinotTaskManager + TaskGenerator
planning Helix tasks, PinotTaskExecutor running them —
pinot-controller/.../helix/core/minion/PinotTaskManager.java,
pinot-minion/.../minion/executor/PinotTaskExecutor.java) and the built-in
tasks (pinot-plugins/pinot-minion-builtin-tasks/.../tasks/{mergerollup,
purge,realtimetoofflinesegments}).

Re-design: no Helix task queues — a task run is generate() (inspect
coordinator metadata, emit work items) followed by execute() (segment
rebuilds through the ordinary builder), with the same atomic
add-new-then-drop-old segment swaps the reference drives through the
controller.  Rollup/merge inherit the vectorized build path, so a "merge"
is one columnar concat + rebuild, not a row-by-row copy.

Port of pinot_tpu/cluster/minion.py (host only): the same five tasks over
the port's Coordinator, build_segment and ImmutableSegment.  A rebuilt
segment reaches the card only through the servers the coordinator places
it on; the swap writes the coordinator's ideal state and segment metadata
directly, as the JAX package's does.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from pinot_tpu_torch.cluster.coordinator import Coordinator
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.segment import ImmutableSegment


def _concat_columns(schema, segments: List[ImmutableSegment]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for f in schema.fields:
        parts = [seg.column(f.name).decoded() for seg in segments]
        nulls = [seg.column(f.name).nulls for seg in segments]
        arrs = []
        for vals, nm in zip(parts, nulls):
            vals = np.asarray(vals)
            if nm is not None and nm.any():
                vals = np.asarray(vals, dtype=object)
                vals[nm] = None
            arrs.append(vals)
        if any(a.dtype == object for a in arrs):
            arrs = [np.asarray(a, dtype=object) for a in arrs]
        out[f.name] = np.concatenate(arrs)
    return out


class MinionTaskManager:
    """Task registry + runner (PinotTaskManager analog)."""

    def __init__(self, coordinator: Coordinator):
        self.coordinator = coordinator
        self.tasks: Dict[str, Callable[..., Dict[str, Any]]] = {
            "MergeRollupTask": self.merge_rollup,
            "PurgeTask": self.purge,
            "RealtimeToOfflineSegmentsTask": self.realtime_to_offline,
            "UpsertCompactionTask": self.upsert_compact,
            "RefreshSegmentTask": self.refresh,
        }

    def run(self, task_type: str, table: str, **kw) -> Dict[str, Any]:
        fn = self.tasks.get(task_type)
        if fn is None:
            raise ValueError(f"unknown minion task {task_type!r} (have {sorted(self.tasks)})")
        return fn(table, **kw)

    # ------------------------------------------------------------------
    def _segment_objects(self, table: str, names: List[str]) -> List[ImmutableSegment]:
        segs = []
        for n in names:
            obj = self.coordinator._find_segment_object(table, n, self.coordinator.live)
            if obj is not None:
                segs.append(obj)
        return segs

    def _swap(self, table: str, new_segments: List[ImmutableSegment], old_names: List[str]) -> None:
        """Atomic-enough replacement: add merged segments, then drop inputs
        (the reference's segment-replacement protocol ordering)."""
        meta = self.coordinator.tables[table]
        for seg in new_segments:
            self.coordinator.add_segment(table, seg)
        for name in old_names:
            for s in meta.ideal.pop(name, set()):
                if s in self.coordinator.servers:
                    self.coordinator.servers[s].drop_segment(table, name)
            meta.segment_meta.pop(name, None)

    # -- MergeRollupTask -------------------------------------------------
    def merge_rollup(
        self,
        table: str,
        max_rows_per_segment: int = 1 << 20,
        min_input_segments: int = 2,
        rollup: bool = False,
    ) -> Dict[str, Any]:
        """Merge small segments into bigger ones; optional rollup collapses
        duplicate dimension combos by re-aggregating metrics (SUM)."""
        coord = self.coordinator
        meta = coord.tables[table]
        small = [
            n
            for n in meta.ideal
            if meta.segment_meta.get(n, {}).get("numDocs", 0) < max_rows_per_segment
        ]
        if len(small) < min_input_segments:
            return {"merged": 0, "inputs": []}
        segments = self._segment_objects(table, small)
        if len(segments) < min_input_segments:
            return {"merged": 0, "inputs": []}
        schema = meta.schema
        data = _concat_columns(schema, segments)
        if rollup:
            data = self._rollup(schema, data)
        name = f"{table}_merged_{int(time.time() * 1000) % 10_000_000}"
        out_rows = len(next(iter(data.values()))) if data else 0
        merged = build_segment(schema, data, name, table_config=meta.config)
        self._swap(table, [merged], small)
        return {"merged": 1, "inputs": small, "outputSegment": name, "outputRows": out_rows}

    @staticmethod
    def _rollup(schema, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        from pinot_tpu_torch.spi.schema import FieldRole

        dims = [f.name for f in schema.fields if f.role is not FieldRole.METRIC]
        metrics = [f.name for f in schema.fields if f.role is FieldRole.METRIC]
        if not dims or not metrics:
            return data
        n = len(data[dims[0]])
        seen: Dict[tuple, int] = {}
        inverse = np.empty(n, dtype=np.int64)
        reps: List[int] = []
        for i in range(n):
            key = tuple(data[d][i] for d in dims)
            j = seen.get(key)
            if j is None:
                j = seen[key] = len(reps)
                reps.append(i)
            inverse[i] = j
        sel = np.asarray(reps, dtype=np.int64)
        out: Dict[str, np.ndarray] = {}
        for d in dims:
            out[d] = np.asarray(data[d])[sel]
        for m in metrics:
            raw = data[m]
            # nullable metrics: None/NaN contribute 0, matching SUM's
            # ignore-nulls semantics (NaN would poison the whole group)
            vals = np.array(
                [0.0 if v is None or (isinstance(v, float) and v != v) else float(v) for v in raw],
                dtype=np.float64,
            )
            out[m] = np.bincount(inverse, weights=vals, minlength=len(sel))
        return out

    # -- PurgeTask -------------------------------------------------------
    def purge(self, table: str, purge_fn: Optional[Callable[[Dict[str, Any]], bool]] = None) -> Dict[str, Any]:
        """Rebuild segments dropping rows purge_fn marks (RecordPurger
        analog — the GDPR-delete path)."""
        if purge_fn is None:
            raise ValueError("PurgeTask needs purge_fn(row_dict) -> bool (True = drop)")
        coord = self.coordinator
        meta = coord.tables[table]
        purged_rows = 0
        rebuilt = []
        for name in list(meta.ideal):
            seg = coord._find_segment_object(table, name, coord.live)
            if seg is None:
                continue
            cols = {f.name: seg.column(f.name).decoded() for f in meta.schema.fields}
            n = seg.num_docs
            drop = np.array(
                [purge_fn({k: cols[k][i] for k in cols}) for i in range(n)], dtype=bool
            )
            if not drop.any():
                continue
            keep = ~drop
            purged_rows += int(drop.sum())
            data = {k: np.asarray(v, dtype=object)[keep] if np.asarray(v).dtype == object else np.asarray(v)[keep] for k, v in cols.items()}
            new_name = f"{name}_purged"
            new_seg = build_segment(meta.schema, data, new_name, table_config=meta.config)
            self._swap(table, [new_seg], [name])
            rebuilt.append(new_name)
        return {"purgedRows": purged_rows, "rebuiltSegments": rebuilt}

    # -- RealtimeToOfflineSegmentsTask ----------------------------------
    def realtime_to_offline(
        self,
        table: str,
        realtime_manager=None,
        offline_table: Optional[str] = None,
        window_end_ms: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Move sealed realtime segments whose time range closed before the
        window end into the offline table, advancing a watermark kept in the
        coordinator metadata (RealtimeToOfflineSegmentsTaskGenerator's
        watermark semantics)."""
        if realtime_manager is None:
            raise ValueError("RealtimeToOfflineSegmentsTask needs the RealtimeTableDataManager")
        offline_table = offline_table or f"{table}_OFFLINE"
        coord = self.coordinator
        if offline_table not in coord.tables:
            coord.add_table(realtime_manager.schema, _offline_config(realtime_manager.config, offline_table))
        meta = coord.tables[offline_table]
        watermark = meta.segment_meta.get("__rto_watermark__", {}).get("value", 0)
        window_end_ms = window_end_ms or int(time.time() * 1000)
        moved = []
        for p, sealed_list in realtime_manager.sealed.items():
            remaining = []
            for seg in sealed_list:
                tr = seg.time_range
                if tr is not None and tr[1] is not None and watermark <= tr[1] < window_end_ms:
                    data = {f.name: seg.column(f.name).decoded() for f in realtime_manager.schema.fields}
                    off = build_segment(
                        realtime_manager.schema,
                        data,
                        f"{offline_table}__{seg.name}",
                        table_config=meta.config,
                    )
                    coord.add_segment(offline_table, off)
                    moved.append(seg.name)
                else:
                    remaining.append(seg)
            realtime_manager.sealed[p] = remaining
        meta.segment_meta["__rto_watermark__"] = {"value": window_end_ms}
        return {"moved": moved, "watermarkMs": window_end_ms, "offlineTable": offline_table}

    # -- UpsertCompactionTask --------------------------------------------
    def upsert_compact(
        self,
        table: str,
        realtime_manager=None,
        invalid_threshold: float = 0.1,
    ) -> Dict[str, Any]:
        """Rewrite sealed realtime segments whose upsert validDocIds mask
        carries >= invalid_threshold masked-out rows, dropping them
        physically (UpsertCompactionTaskExecutor analog — the reference
        reads the server's validDocIds snapshot the same way).

        Compaction preserves surviving-row order (no re-sort), so the
        partition upsert manager's pk_map locations remap through the
        kept-row prefix; the fresh mask is all-true.  The swap is
        in-memory — on restart the manager replays raw rows and rebuilds
        equivalent masks (bootstrap path), so durability is unaffected."""
        import dataclasses

        rt = realtime_manager or self.coordinator.realtime.get(table)
        if rt is None or getattr(rt, "upsert", None) is None:
            raise ValueError(f"UpsertCompactionTask needs an upsert-enabled realtime table ({table!r})")
        um = rt.upsert
        cfg = dataclasses.replace(
            rt.config, indexing=dataclasses.replace(rt.config.indexing, sorted_column=None)
        )
        report = {"compacted": [], "rowsDropped": 0}
        remaps: Dict[str, Dict[int, int]] = {}  # segment -> old doc -> new doc
        for p, sealed_list in rt.sealed.items():
            out_list = []
            for seg in sealed_list:
                mask = seg.valid_docs
                inv = int((~np.asarray(mask, dtype=bool)).sum()) if mask is not None else 0
                if inv == 0 or inv / max(1, seg.num_docs) < invalid_threshold:
                    out_list.append(seg)
                    continue
                keep = np.nonzero(np.asarray(mask, dtype=bool))[0]
                data = _concat_columns(rt.schema, [seg])
                data = {k: v[keep] for k, v in data.items()}
                new_seg = build_segment(rt.schema, data, seg.name, cfg)
                remaps[seg.name] = {int(d): j for j, d in enumerate(keep)}
                fresh = np.ones(len(keep), dtype=bool)
                um.valid[seg.name] = fresh
                new_seg.valid_docs = fresh
                out_list.append(new_seg)
                report["compacted"].append(seg.name)
                report["rowsDropped"] += inv
            rt.sealed[p] = out_list
        if remaps:  # one pk_map pass for all compacted segments
            for loc in um.pk_map.values():
                m = remaps.get(loc.segment)
                if m is None:
                    continue
                # a tracked doc missing from the kept set was itself invalid
                # (a delete tombstone's own row): mark it compacted-away so
                # later invalidations/reads don't touch a reused index
                # (review-caught stale-location bug)
                loc.doc = m.get(loc.doc, -1)
        return report

    # -- RefreshSegmentTask ----------------------------------------------
    def refresh(self, table: str, segment_name: Optional[str] = None) -> Dict[str, Any]:
        """Rebuild offline segments with the table's CURRENT config/schema —
        picks up newly configured indexes, sort columns, dictionary changes
        (RefreshSegmentTaskExecutor analog)."""
        meta = self.coordinator.tables[table]
        names = [segment_name] if segment_name else list(meta.ideal)
        refreshed = []
        for name in names:
            segs = self._segment_objects(table, [name])
            if not segs:
                continue
            data = _concat_columns(meta.schema, segs)
            new_seg = build_segment(meta.schema, data, name, meta.config)
            # drop the old assignment, then re-add under the same name
            for s in meta.ideal.pop(name, set()):
                if s in self.coordinator.servers:
                    self.coordinator.servers[s].drop_segment(table, name)
            meta.segment_meta.pop(name, None)
            self.coordinator.add_segment(table, new_seg)
            refreshed.append(name)
        return {"refreshed": refreshed}


def _offline_config(cfg, name: str):
    import dataclasses

    from pinot_tpu_torch.spi.config import TableType

    return dataclasses.replace(cfg, name=name, table_type=TableType.OFFLINE, stream=None)
