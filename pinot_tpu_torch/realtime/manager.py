"""Realtime consumption: per-partition consume loop + seal/swap + resume.

Copy of pinot_tpu/realtime/manager.py (host-only).  The data directory
(sealed segments in the shared on-disk format, checkpoint.json and its
.bak, with the same keys) is the JAX package's, so a directory either
package wrote recovers under the other.  A seal uploads its segment to the
deep store (cluster/deepstore.py SegmentDeepStore, which the coordinator's
add_realtime_table passes in; any object with put_segment / has_segment /
fetch_segment does) before the checkpoint commits.  After a seal the consuming segment's last snapshot frees
its device columns (realtime/mutable.py).

Reference parity: RealtimeSegmentDataManager (pinot-core/.../data/manager/
realtime/RealtimeSegmentDataManager.java — consumeLoop :470, fetch :492,
processStreamEvents :591, end-criteria checks, commitSegment :971) and
RealtimeTableDataManager (.../realtime/RealtimeTableDataManager.java:97).

Re-design: the reference runs one consumer thread per partition with a
controller-driven commit FSM; here consumption is *step-driven* —
`consume()` pulls batches until caught up or a segment seals — so tests and
embedding hosts control interleaving deterministically, and a thread driver
(`run_forever`) is a loop around the same step.  The commit protocol
collapses to: seal -> durable immutable build -> atomic swap into the table
view -> checkpoint {offset, seq} fsynced to disk.  Restart replays from the
last committed offset: consuming-segment rows are intentionally dropped and
re-consumed (exactly the reference's recovery semantics — uncommitted rows
live only in the mutable segment).
"""
from __future__ import annotations

import copy
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.realtime.stream import InMemoryStream, PartitionGroupConsumer, make_consumer
from pinot_tpu_torch.realtime.upsert import PartitionDedupMetadataManager, PartitionUpsertMetadataManager
from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.segment.store import SegmentCorruptError
from pinot_tpu_torch.spi.config import TableConfig
from pinot_tpu_torch.spi.filesystem import fsync_dir, sweep_tmp
from pinot_tpu_torch.spi.schema import Schema
from pinot_tpu_torch.utils.crashpoints import crash_point
from pinot_tpu_torch.utils.metrics import METRICS

log = logging.getLogger("pinot_tpu_torch.realtime")


def segment_name(table: str, partition: int, seq: int) -> str:
    """LLCSegmentName analog: table__partition__sequence."""
    return f"{table}__{partition}__{seq}"


class RealtimeSegmentDataManager:
    """Owns one partition's consuming segment + its consume loop."""

    def __init__(
        self,
        table: "RealtimeTableDataManager",
        partition: int,
        consumer: PartitionGroupConsumer,
        start_offset: int = 0,
        seq: int = 0,
    ):
        self.table = table
        self.partition = partition
        self.consumer = consumer
        self.offset = start_offset
        self.seq = seq
        # monotonic: segment age (seal criteria) is an elapsed-time measure
        self.segment_start_ms = time.monotonic() * 1000
        self.mutable = MutableSegment(
            table.schema,
            segment_name(table.config.name, partition, seq),
            table.config,
            start_offset=start_offset,
        )

    # -- consume loop ----------------------------------------------------
    def consume(self, max_batches: Optional[int] = None, batch_size: int = 1024) -> int:
        """Pull batches until caught up, a segment seals, or max_batches.
        Returns rows ingested (consumeLoop + processStreamEvents analog)."""
        ingested = 0
        batches = 0
        while max_batches is None or batches < max_batches:
            batch = self.consumer.fetch(self.offset, batch_size)
            batches += 1
            sealed = False
            for msg in batch.messages:
                if not self.table._should_index(self, msg):
                    self.offset = msg.offset
                    continue
                row = self.table._transform_row(self, msg)
                doc_id = self.mutable.index(row)
                self.table._on_indexed(self, msg, doc_id)
                self.offset = msg.offset
                ingested += 1
                # per-row end-criteria check: segments seal at EXACTLY the
                # configured row cap (the reference's canTakeMore guard),
                # mid-batch if needed; the tail of the batch re-fetches into
                # the rolled segment on the next loop iteration.
                if self._end_criteria_reached():
                    self.seal_and_swap()
                    sealed = True
                    break
            if sealed:
                break
            self.offset = batch.next_offset
            # empty batch = caught up, even if the partition never "ends"
            # (Kafka-like live streams); without this, max_batches=None spins
            if batch.end_of_partition or not batch.messages:
                break
        return ingested

    def _end_criteria_reached(self) -> bool:
        cfg = self.table.config.stream
        if cfg is None:
            return False
        if self.mutable.num_docs >= cfg.max_rows_per_segment:
            return True
        age_s = (time.monotonic() * 1000 - self.segment_start_ms) / 1000
        return self.mutable.num_docs > 0 and age_s >= cfg.max_segment_seconds

    # -- commit ----------------------------------------------------------
    def seal_and_swap(self) -> ImmutableSegment:
        """End-of-segment commit: durable build, swap, checkpoint, roll.

        Order matters (crash safety): the immutable segment hits disk BEFORE
        the checkpoint advances, so a crash between the two replays into a
        duplicate *file* (overwritten on rebuild), never into lost rows."""
        sealed = self.mutable.seal(output_dir=self.table.segment_dir(self.mutable.name))
        crash_point("segment.seal.after_build")
        # deep-store copy BEFORE the checkpoint references the segment as
        # committed: once {offset, seq} advances, the segment must survive
        # the loss of this host's data dir (segment completion protocol)
        if self.table.deep_store is not None:
            self.table.deep_store.put_segment(self.table.config.name, sealed)
        crash_point("segment.seal.after_upload")
        self.table._swap_in(self.partition, sealed)
        crash_point("segment.seal.after_swap")
        self.seq += 1
        self.table._commit_checkpoint(self.partition, self.offset, self.seq)
        self.segment_start_ms = time.monotonic() * 1000
        self.mutable.release_snapshot()
        self.mutable = MutableSegment(
            self.table.schema,
            segment_name(self.table.config.name, self.partition, self.seq),
            self.table.config,
            start_offset=self.offset,
        )
        self.table._on_rolled(self)
        return sealed

    def run_forever(self, poll_interval_s: float = 0.05, stop_event: Optional[threading.Event] = None) -> None:
        """Thread driver: the reference's PartitionConsumer thread."""
        while stop_event is None or not stop_event.is_set():
            n = self.consume(max_batches=4)
            if n == 0:
                time.sleep(poll_interval_s)


class RealtimeTableDataManager:
    """All partitions of one realtime table: sealed + consuming segments.

    data_dir layout:
      {data_dir}/{segment_name}/...   - sealed immutable segments
      {data_dir}/checkpoint.json      - {partition: {offset, seq, segments}}
    """

    def __init__(
        self,
        schema: Schema,
        config: TableConfig,
        data_dir: str,
        stream: Optional[InMemoryStream] = None,
        num_partitions: Optional[int] = None,
        deep_store=None,
    ):
        if config.stream is None:
            raise ValueError(f"table {config.name} has no streamConfigs")
        self.schema = schema
        self.config = config
        self.data_dir = data_dir
        self.stream = stream
        # segment deep store (cluster/deepstore.py): sealed segments are
        # uploaded at commit time and corrupt local copies re-download
        self.deep_store = deep_store
        # checkpoint-committed hook: fn(partition, offset, seq), called
        # AFTER the fsync'd commit — the coordinator journals the pointer
        self.on_checkpoint = None
        os.makedirs(data_dir, exist_ok=True)
        if num_partitions is None:
            num_partitions = stream.num_partitions if stream is not None else 1
        self.num_partitions = num_partitions
        self.sealed: Dict[int, List[ImmutableSegment]] = {p: [] for p in range(num_partitions)}
        self.managers: Dict[int, RealtimeSegmentDataManager] = {}
        self._checkpoint = self._load_checkpoint()
        self._lock = threading.Lock()
        for p in range(num_partitions):
            self._recover_partition(p)
            cp = self._checkpoint.get(str(p), {"offset": 0, "seq": 0})
            consumer = make_consumer(config.stream, p, stream=stream)
            self.managers[p] = RealtimeSegmentDataManager(
                self, p, consumer, start_offset=cp["offset"], seq=cp["seq"]
            )
        # upsert / dedup metadata (realtime/upsert.py), bootstrapped by
        # replaying recovered sealed segments in (partition, seq) order
        self.upsert = None
        self.dedup = None
        recovered = [s for p in range(num_partitions) for s in self.sealed[p]]
        if config.upsert is not None and config.upsert.mode != "NONE":
            self.upsert = PartitionUpsertMetadataManager(schema, config)
            self.upsert.bootstrap(recovered)
            for mgr in self.managers.values():
                self.upsert.track_consuming(mgr.mutable.name)
        if config.dedup is not None and config.dedup.enabled:
            self.dedup = PartitionDedupMetadataManager(schema, config)
            self.dedup.bootstrap(recovered)

    # -- durability ------------------------------------------------------
    def segment_dir(self, name: str) -> str:
        return os.path.join(self.data_dir, name)

    def _checkpoint_path(self) -> str:
        return os.path.join(self.data_dir, "checkpoint.json")

    def _load_checkpoint(self) -> Dict[str, Any]:
        """Load the committed checkpoint, tolerating the artifacts a crash
        can leave: stale *.tmp files are swept; a corrupt checkpoint.json is
        quarantined aside (evidence, not deleted) and the previous committed
        state (checkpoint.json.bak) — or empty — is recovered instead.
        Recovery from an older checkpoint is safe by construction: offsets
        only re-consume, and sealed-segment files overwrite idempotently."""
        sweep_tmp(self.data_dir)
        path = self._checkpoint_path()
        for candidate in (path, path + ".bak"):
            if not os.path.exists(candidate):
                continue
            try:
                with open(candidate, "r", encoding="utf-8") as f:
                    return json.load(f)
            except (json.JSONDecodeError, OSError, ValueError) as e:
                METRICS.counter("realtime.checkpointCorrupt").inc()
                aside = candidate + ".corrupt"
                try:
                    if os.path.exists(aside):
                        os.remove(aside)
                    os.replace(candidate, aside)
                except OSError:
                    aside = None
                log.warning(
                    "corrupt realtime checkpoint %s (%s) quarantined to %s; "
                    "recovering from previous state", candidate, e, aside,
                )
        return {}

    def _commit_checkpoint(self, partition: int, offset: int, seq: int) -> None:
        """Advance one partition's committed {offset, seq, segments} pointer.

        The shared checkpoint dict is mutated AND deep-copied under _lock —
        a concurrent partition's commit can neither interleave a half-updated
        entry into this dump nor mutate a list while json serializes it (the
        race the old code had by dumping the live dict outside the lock).
        The dump itself runs on the copy, outside the lock."""
        with self._lock:
            cp = self._checkpoint.setdefault(str(partition), {"offset": 0, "seq": 0, "segments": []})
            cp["offset"] = offset
            cp["seq"] = seq
            cp["segments"] = [s.name for s in self.sealed[partition]]
            snapshot = copy.deepcopy(self._checkpoint)
        path = self._checkpoint_path()
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snapshot, f)
            crash_point("realtime.checkpoint.after_write")
            f.flush()
            os.fsync(f.fileno())
        # keep the last committed checkpoint as the corruption fallback
        if os.path.exists(path):
            bak = path + ".bak"
            try:
                os.replace(path, bak)
            except OSError:
                pass
        crash_point("realtime.checkpoint.after_bak")
        os.replace(tmp, path)
        crash_point("realtime.checkpoint.after_replace")
        fsync_dir(self.data_dir)
        if self.on_checkpoint is not None:
            self.on_checkpoint(partition, offset, seq)

    def _recover_partition(self, partition: int) -> None:
        """Reload committed sealed segments from disk (restart path),
        CRC-verifying each; a missing/corrupt local copy re-downloads from
        the deep store (it was uploaded before the checkpoint committed)."""
        cp = self._checkpoint.get(str(partition))
        if not cp:
            return
        table_name = self.config.name
        for name in cp.get("segments", []):
            path = self.segment_dir(name)
            seg = None
            try:
                if os.path.isdir(path):
                    seg = ImmutableSegment.load(path, verify=True)
            except SegmentCorruptError as e:
                METRICS.counter("realtime.segmentsCorrupt").inc()
                aside = path + ".corrupt"
                shutil.rmtree(aside, ignore_errors=True)
                os.replace(path, aside)
                log.warning("quarantined corrupt sealed segment %s (%s)", path, e)
            if seg is None and self.deep_store is not None and self.deep_store.has_segment(table_name, name):
                seg = self.deep_store.fetch_segment(table_name, name, self.data_dir)
                METRICS.counter("realtime.segmentsRestored").inc()
            if seg is not None:
                self.sealed[partition].append(seg)
            else:
                METRICS.counter("realtime.segmentsUnrecoverable").inc()
                log.error(
                    "committed sealed segment %s/%s is in neither the data dir "
                    "nor the deep store", table_name, name,
                )

    # -- swap/roll hooks -------------------------------------------------
    def _swap_in(self, partition: int, sealed: ImmutableSegment) -> None:
        with self._lock:
            self.sealed[partition].append(sealed)
        if self.upsert is not None:
            self.upsert.on_seal(self.managers.get(partition), sealed)

    def _should_index(self, mgr: RealtimeSegmentDataManager, msg) -> bool:
        if self.dedup is not None:
            return self.dedup.should_index(mgr, msg)
        return True

    def _transform_row(self, mgr: RealtimeSegmentDataManager, msg) -> Dict[str, Any]:
        """Record-transform hook: PARTIAL upsert merges the incoming row
        with the current winning row before indexing."""
        if self.upsert is not None:
            return self.upsert.transform_row(self, mgr, msg)
        return msg.value

    def _on_indexed(self, mgr: RealtimeSegmentDataManager, msg, doc_id: int) -> None:
        if self.upsert is not None:
            self.upsert.on_indexed(mgr, msg, doc_id)

    def _on_rolled(self, mgr: RealtimeSegmentDataManager) -> None:
        if self.upsert is not None:
            self.upsert.on_rolled(mgr)

    # -- consumption driver ----------------------------------------------
    def consume_all(self, max_batches: Optional[int] = None) -> int:
        """Step every partition's consumer (test/simulation driver)."""
        total = 0
        for mgr in self.managers.values():
            while True:
                n = mgr.consume(max_batches=max_batches)
                total += n
                if n == 0 or max_batches is not None:
                    break
        return total

    # -- query view ------------------------------------------------------
    def query_segments(self) -> List[ImmutableSegment]:
        """Sealed segments + a snapshot of each non-empty consuming segment —
        the segment list the broker's routing table would return."""
        out: List[ImmutableSegment] = []
        for p in range(self.num_partitions):
            with self._lock:
                out.extend(self.sealed[p])
            mgr = self.managers.get(p)
            if mgr is not None and mgr.mutable.num_docs > 0:
                snap = mgr.mutable.snapshot()
                if self.upsert is not None:
                    self.upsert.attach_snapshot_mask(snap, mgr.mutable.name)
                out.append(snap)
        return out

    @property
    def total_rows(self) -> int:
        with self._lock:
            sealed_rows = sum(s.num_docs for segs in self.sealed.values() for s in segs)
        return sealed_rows + sum(m.mutable.num_docs for m in self.managers.values())
