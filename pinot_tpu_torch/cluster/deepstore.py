"""Segment deep store: durable segment home behind the PinotFS SPI.

Reference parity: Pinot's segment deep store (controller data dir / S3) and
the segment-completion protocol — a sealed or uploaded segment is copied to
the deep store BEFORE its metadata commits, so any server holding it on the card
can be killed and re-materialized from durable storage (the Taurus
separation of durable storage from serving compute, PAPERS.md).  Layout:

  {root}/{table}/{segment_name}/columns.bin + metadata.json

Upload commits by directory rename: the segment is staged under
`.staging-{name}`, then moved into place — readers either see a complete
segment directory or none (kill-point `deepstore.upload.before_commit`
between the copy and the move proves it).  Downloads verify size + CRC32
against the committed metadata before the local copy is trusted; a corrupt
local segment is quarantined and re-downloaded.

Port of pinot_tpu/cluster/deepstore.py (host only): the realtime manager's
seal (realtime/manager.py) and the coordinator's add_segment upload through
it; servers restore from it with ServerInstance.restore_segment.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import List, Optional

from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.segment.store import SegmentCorruptError, verify_segment
from pinot_tpu_torch.spi.filesystem import PinotFS, fs_for_uri, fsync_dir, strip_scheme
from pinot_tpu_torch.utils.crashpoints import crash_point
from pinot_tpu_torch.utils.metrics import METRICS

log = logging.getLogger("pinot_tpu_torch.cluster")


class SegmentDeepStore:
    """Durable table/segment tree over a PinotFS (local first-party; cloud
    schemes via spi.filesystem.register_fs)."""

    def __init__(self, root_uri: str, fs: Optional[PinotFS] = None):
        self.root = strip_scheme(root_uri)
        self.fs = fs if fs is not None else fs_for_uri(root_uri)
        self.fs.mkdir(self.root)

    # -- paths -----------------------------------------------------------
    def segment_uri(self, table: str, name: str) -> str:
        return os.path.join(self.root, table, name)

    def _staging_uri(self, table: str, name: str) -> str:
        return os.path.join(self.root, table, f".staging-{name}")

    # -- queries ---------------------------------------------------------
    def has_segment(self, table: str, name: str) -> bool:
        return self.fs.exists(os.path.join(self.segment_uri(table, name), "metadata.json"))

    def list_segments(self, table: str) -> List[str]:
        tdir = os.path.join(self.root, table)
        if not self.fs.exists(tdir):
            return []
        out = []
        for p in self.fs.list_files(tdir):
            base = os.path.basename(p.rstrip("/"))
            if not base.startswith(".staging-") and self.fs.exists(os.path.join(p, "metadata.json")):
                out.append(base)
        return sorted(out)

    # -- upload (segment completion: copy -> verify -> commit-by-rename) --
    def upload(self, table: str, local_dir: str, name: Optional[str] = None) -> str:
        """Copy a sealed local segment directory into the deep store.
        Idempotent: re-uploading an already-committed segment is a no-op
        (the first committed copy wins — segment content is immutable)."""
        name = name or os.path.basename(os.path.normpath(local_dir))
        if self.has_segment(table, name):
            return self.segment_uri(table, name)
        verify_segment(local_dir)  # never upload a torn local build
        staging = self._staging_uri(table, name)
        if self.fs.exists(staging):
            self.fs.delete(staging, force=True)  # stale crash leftover
        self.fs.copy_from_local(local_dir, staging)
        crash_point("deepstore.upload.before_commit")
        final = self.segment_uri(table, name)
        if self.fs.exists(final):  # lost a concurrent-upload race: fine
            self.fs.delete(staging, force=True)
        else:
            self.fs.move(staging, final)
        fsync_dir(os.path.dirname(final))
        crash_point("deepstore.upload.after_commit")
        METRICS.counter("deepstore.uploads").inc()
        return final

    def put_segment(self, table: str, segment: ImmutableSegment) -> Optional[str]:
        """Upload a segment object, serializing it first if it was built
        in-memory (no durable source_dir yet).  Returns the deep-store URI,
        or None for consuming-segment snapshots (not yet durable by
        design — uncommitted rows replay from the stream)."""
        if getattr(segment, "in_memory", False):
            return None
        if self.has_segment(table, segment.name):
            return self.segment_uri(table, segment.name)
        src = segment.source_dir
        if src is None or not os.path.isdir(src):
            staging = self._staging_uri(table, f"build-{segment.name}")
            if os.path.isdir(staging):
                shutil.rmtree(staging)
            os.makedirs(os.path.dirname(staging), exist_ok=True)
            segment.save(staging)
            try:
                return self.upload(table, staging, name=segment.name)
            finally:
                shutil.rmtree(staging, ignore_errors=True)
        return self.upload(table, src, name=segment.name)

    # -- download (restart recovery: fetch -> verify -> commit-by-rename) --
    def download(self, table: str, name: str, local_dir: str) -> str:
        """Materialize a deep-store segment at {local_dir}/{name}, verified.
        An existing VALID local copy is reused; a corrupt one is quarantined
        aside and re-fetched."""
        dst = os.path.join(local_dir, name)
        if os.path.isdir(dst):
            try:
                verify_segment(dst)
                return dst
            except SegmentCorruptError as e:
                METRICS.counter("deepstore.corruptLocalCopies").inc()
                aside = dst + ".corrupt"
                shutil.rmtree(aside, ignore_errors=True)
                os.replace(dst, aside)
                log.warning("quarantined corrupt local segment %s (%s)", dst, e)
        src = self.segment_uri(table, name)
        if not self.has_segment(table, name):
            raise FileNotFoundError(f"deep store has no segment {table}/{name}")
        tmp = dst + ".download"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(local_dir, exist_ok=True)
        self.fs.copy_to_local(src, tmp)
        verify_segment(tmp)  # reject a torn/corrupt transfer before commit
        crash_point("deepstore.download.before_commit")
        os.replace(tmp, dst)
        fsync_dir(local_dir)
        METRICS.counter("deepstore.downloads").inc()
        return dst

    def fetch_segment(self, table: str, name: str, local_dir: str) -> ImmutableSegment:
        """Download (or reuse a verified local copy) and load, CRC-checked."""
        return ImmutableSegment.load(self.download(table, name, local_dir), verify=True)
