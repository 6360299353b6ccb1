"""Upsert + dedup metadata: PK -> latest location, validDocIds bitmasks.

Copy of pinot_tpu/realtime/upsert.py (host-only).  Reference parity:
pinot-segment-local ConcurrentMapPartitionUpsertMetadataManager
(addOrReplaceSegment / addRecord :71-115 — PK hash map holding the winning
(segment, docId, comparisonValue); losing rows cleared from their segment's
validDocIds bitmap) and PartitionDedupMetadataManager (drop-duplicate-PK).

Re-design: validDocIds is a host numpy bool mask per segment, shipped to the
device with each query as a filter param (query/planner.py "__valid__") and
ANDed into every predicate — the device form of the reference's
MutableRoaringBitmap intersected in FilterPlanNode.  A sealed segment's mask
is this manager's array itself, cleared in place by later invalidations, so
it never enters a segment's device cache.  Comparison defaults to the
table's time column; later arrival wins ties (>=), matching the reference.  On restart the map is
bootstrapped by replaying sealed segments in sequence order
(addOrReplaceSegment's rebuild path) — no separate snapshot file needed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.spi.config import TableConfig
from pinot_tpu_torch.spi.schema import Schema


def _as_elems(v) -> Tuple:
    """Normalize a value to MV elements: None -> (), scalar -> (v,)."""
    if v is None:
        return ()
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(v)
    return (v,)


class _Location:
    __slots__ = ("segment", "doc", "cmp", "deleted")

    def __init__(self, segment: str, doc: int, cmp: Any, deleted: bool = False):
        self.segment = segment
        self.doc = doc
        self.cmp = cmp
        self.deleted = deleted


class PartitionUpsertMetadataManager:
    """FULL upsert: latest row per primary key wins; older rows are masked
    out of their segment's validDocIds."""

    def __init__(self, schema: Schema, config: TableConfig):
        if not schema.primary_key_columns:
            raise ValueError(f"upsert table {config.name} needs primaryKeyColumns in the schema")
        self.schema = schema
        self.config = config
        self.pk_cols = list(schema.primary_key_columns)
        cc = (config.upsert.comparison_column if config.upsert else None) or config.segments.time_column
        if not cc:
            raise ValueError(
                "upsert requires a comparison column (upsertConfig.comparisonColumn or the table time column)"
            )
        self.cmp_col = cc
        # pk tuple -> winning location; valid masks by segment name.
        self.pk_map: Dict[Tuple, _Location] = {}
        self.valid: Dict[str, Any] = {}  # list[bool] (consuming) | np.ndarray (sealed)
        self._strategies = {
            k.lower(): v.upper()
            for k, v in (config.upsert.partial_upsert_strategies if config.upsert else {}).items()
        }
        up = config.upsert
        # metadataTTL: keys whose comparison value trails the watermark by
        # more than this stop being tracked (reference
        # ConcurrentMapPartitionUpsertMetadataManager.java:49); their rows
        # stay valid — only dedup/replace tracking ends, as in the reference
        self.metadata_ttl = float(getattr(up, "metadata_ttl", 0.0) or 0.0) if up else 0.0
        self.delete_col = getattr(up, "delete_record_column", None) if up else None
        self._cmp_watermark: Optional[float] = None
        self._adds_since_expiry = 0

    # -- metadataTTL -----------------------------------------------------
    def _note_watermark(self, cmp: Any) -> None:
        if self.metadata_ttl <= 0:
            return
        try:
            c = float(cmp)
        except (TypeError, ValueError):
            return
        if self._cmp_watermark is None or c > self._cmp_watermark:
            self._cmp_watermark = c
        self._adds_since_expiry += 1
        if self._adds_since_expiry >= 1024:
            self.expire_ttl_keys()

    def expire_ttl_keys(self) -> None:
        """Drop pk_map entries older than (watermark - metadataTTL).  Their
        rows remain visible (valid masks untouched) except expired DELETE
        tombstones, which simply stop rejecting older arrivals."""
        self._adds_since_expiry = 0
        if self.metadata_ttl <= 0 or self._cmp_watermark is None:
            return
        floor = self._cmp_watermark - self.metadata_ttl
        dead = []
        for pk, loc in self.pk_map.items():
            try:
                if float(loc.cmp) < floor:
                    dead.append(pk)
            except (TypeError, ValueError):
                continue
        for pk in dead:
            del self.pk_map[pk]

    # -- helpers ---------------------------------------------------------
    def _pk_of(self, row: Dict[str, Any]) -> Tuple:
        return tuple(row.get(c) for c in self.pk_cols)

    def _resolve(self, pk: Tuple, cand: _Location) -> None:
        """addRecord: candidate vs incumbent; later arrival wins ties."""
        cur = self.pk_map.get(pk)
        if cur is None:
            self.pk_map[pk] = cand
            return
        if cand.cmp >= cur.cmp:
            self._invalidate(cur)
            self.pk_map[pk] = cand
        else:
            self._invalidate(cand)

    def _invalidate(self, loc: _Location) -> None:
        if loc.doc < 0:  # compacted-away doc (delete tombstone): nothing to mask
            return
        mask = self.valid.get(loc.segment)
        if mask is not None:
            mask[loc.doc] = False

    # -- consume-loop hooks (RealtimeTableDataManager calls these) -------
    def track_consuming(self, name: str) -> None:
        self.valid.setdefault(name, [])

    def on_indexed(self, mgr, msg, doc_id: int) -> None:
        name = mgr.mutable.name
        self.track_consuming(name)
        self.valid[name].append(True)
        row = msg.value
        cmp = row.get(self.cmp_col)
        self._note_watermark(cmp)
        deleted = bool(self.delete_col and row.get(self.delete_col))
        loc = _Location(name, doc_id, cmp, deleted=deleted)
        self._resolve(self._pk_of(row), loc)
        if deleted and self.pk_map.get(self._pk_of(row)) is loc:
            # consistent delete: the winning tombstone hides its own row too;
            # it stays in pk_map (rejecting older arrivals) until TTL expiry
            self._invalidate(loc)

    def on_seal(self, mgr, sealed: ImmutableSegment) -> None:
        """Freeze the consuming mask into the sealed segment, remapping
        through the builder's sort permutation when the build reordered rows."""
        name = sealed.name
        mask = np.asarray(self.valid.get(name, []), dtype=bool)
        if len(mask) != sealed.num_docs:
            mask = np.ones(sealed.num_docs, dtype=bool)
        order = sealed.sort_order
        if order is not None:
            mask = mask[order]  # new position p holds input row order[p]
            inverse = np.empty_like(order)
            inverse[order] = np.arange(len(order))
            for loc in self.pk_map.values():
                if loc.segment == name:
                    loc.doc = int(inverse[loc.doc])
        self.valid[name] = mask
        sealed.valid_docs = mask  # shared reference: later invalidations apply

    def on_rolled(self, mgr) -> None:
        self.track_consuming(mgr.mutable.name)

    # -- PARTIAL upsert ---------------------------------------------------
    def transform_row(self, table_mgr, mgr, msg) -> Dict[str, Any]:
        """PARTIAL mode: merge the incoming row with the current winning row
        per column strategy (PartialUpsertHandler analog).  Strategies:
        OVERWRITE (default; incoming None keeps old), IGNORE (keep old),
        INCREMENT (old + new), APPEND (old MV elements + new), UNION
        (order-preserving MV set union)."""
        row = msg.value
        if (self.config.upsert.mode or "").upper() != "PARTIAL":
            return row
        cur = self.pk_map.get(self._pk_of(row))
        if cur is None or cur.deleted:  # deleted PK: merge against nothing
            return row
        old = self._read_row(table_mgr, cur)
        if old is None:
            return row
        merged: Dict[str, Any] = {}
        strategies = self._strategies
        for f in self.schema.fields:
            name = f.name
            strat = strategies.get(name.lower(), "OVERWRITE")
            new_v, old_v = row.get(name), old.get(name)
            if name in self.pk_cols or name == self.cmp_col:
                merged[name] = new_v
            elif strat == "IGNORE":
                merged[name] = old_v
            elif strat == "INCREMENT":
                merged[name] = (old_v or 0) + (new_v or 0)
            elif strat == "APPEND":
                # MV realtime (round 5): concatenate old + incoming elements
                merged[name] = tuple(_as_elems(old_v)) + tuple(_as_elems(new_v))
            elif strat == "UNION":
                out = list(_as_elems(old_v))
                for e in _as_elems(new_v):
                    if e not in out:
                        out.append(e)
                merged[name] = tuple(out)
            else:  # OVERWRITE
                merged[name] = new_v if new_v is not None else old_v
        return merged

    def _read_row(self, table_mgr, loc: _Location) -> Optional[Dict[str, Any]]:
        """Point-read the winning row's values at its current location."""
        if loc.doc < 0:  # compacted-away (tombstone): no row to read
            return None
        for mgr in table_mgr.managers.values():
            if mgr.mutable.name == loc.segment:
                return {f.name: mgr.mutable.value_at(f.name, loc.doc) for f in self.schema.fields}
        for segs in table_mgr.sealed.values():
            for seg in segs:
                if seg.name == loc.segment:
                    # point reads, NOT full-column decodes (O(1) per field)
                    return {f.name: seg.column(f.name).value_at(loc.doc) for f in self.schema.fields}
        return None

    # -- query-time ------------------------------------------------------
    def attach_snapshot_mask(self, snapshot: ImmutableSegment, name: str) -> None:
        """Consuming snapshots get a frozen copy of the live mask (the list
        keeps growing; the snapshot covers a row-count prefix)."""
        mask = self.valid.get(name)
        if mask is None:
            return
        snapshot.valid_docs = np.asarray(mask[: snapshot.num_docs], dtype=bool)

    # -- restart ---------------------------------------------------------
    def bootstrap(self, sealed_in_order: List[ImmutableSegment]) -> None:
        """Rebuild pk_map + validDocIds by replaying sealed segments in
        sequence order (the reference's addOrReplaceSegment path)."""
        for seg in sealed_in_order:
            n = seg.num_docs
            self.valid[seg.name] = np.ones(n, dtype=bool)
            seg.valid_docs = self.valid[seg.name]
            pk_vals = [seg.column(c).decoded() for c in self.pk_cols]
            cmp_vals = seg.column(self.cmp_col).decoded()
            del_vals = (
                seg.column(self.delete_col).decoded()
                if self.delete_col and self.delete_col in seg.columns
                else None
            )
            for doc in range(n):
                pk = tuple(v[doc].item() if isinstance(v[doc], np.generic) else v[doc] for v in pk_vals)
                cmp = cmp_vals[doc]
                cmp = cmp.item() if isinstance(cmp, np.generic) else cmp
                self._note_watermark(cmp)
                deleted = bool(del_vals[doc]) if del_vals is not None else False
                loc = _Location(seg.name, doc, cmp, deleted=deleted)
                self._resolve(pk, loc)
                if deleted and self.pk_map.get(pk) is loc:
                    self._invalidate(loc)


class PartitionDedupMetadataManager:
    """Dedup: the FIRST row per primary key is kept; later duplicates are
    dropped before indexing (PartitionDedupMetadataManager analog)."""

    def __init__(self, schema: Schema, config: TableConfig):
        if not schema.primary_key_columns:
            raise ValueError(f"dedup table {config.name} needs primaryKeyColumns in the schema")
        self.pk_cols = list(schema.primary_key_columns)
        self.seen: set = set()

    def _pk_of(self, row: Dict[str, Any]) -> Tuple:
        return tuple(row.get(c) for c in self.pk_cols)

    def should_index(self, mgr, msg) -> bool:
        pk = self._pk_of(msg.value)
        if pk in self.seen:
            return False
        self.seen.add(pk)
        return True

    def bootstrap(self, sealed_in_order: List[ImmutableSegment]) -> None:
        for seg in sealed_in_order:
            pk_vals = [seg.column(c).decoded() for c in self.pk_cols]
            for doc in range(seg.num_docs):
                self.seen.add(
                    tuple(v[doc].item() if isinstance(v[doc], np.generic) else v[doc] for v in pk_vals)
                )
