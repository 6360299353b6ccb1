"""Materialized views: time-bucketed pre-aggregations with query rewrite.

Reference parity: the fork's pinot-materialized-view module (17.7k LoC;
pinot-materialized-view/DESIGN.md) — MV definitions kept in cluster
metadata, minion refresh tasks per time bucket, watermark + STALE-bucket
invalidation, and broker query rewrite when the MV is fresh.

Re-design essentials kept: an MV is a real table whose segments are one per
time bucket; refresh re-runs the MV query per bucket through the ordinary
engine and swaps the bucket segment; freshness is per-bucket (the set of
source segments that fed the bucket's last refresh); the broker rewrites a
matching aggregate query onto the MV only when every touched bucket is
fresh — otherwise it silently falls back to the source table (same
contract as the reference's watermark check).

Port of pinot_tpu/cluster/mview.py (host only): a refresh is one broker
query a stale bucket (fused-scan launches on the servers), and a rewritten
query is one broker query over the view's table.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from pinot_tpu_torch.cluster.broker import Broker
from pinot_tpu_torch.cluster.coordinator import Coordinator
from pinot_tpu_torch.query.ir import AggregationSpec, Expr, FilterOp, QueryContext
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.spi.config import SegmentsConfig, TableConfig
from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

MS_DAY = 86_400_000

# source aggregation -> (mv column suffix, combine aggregation on the MV)
_AGG_MAP = {
    "count": ("count", "sum"),
    "sum": ("sum", "sum"),
    "min": ("min", "min"),
    "max": ("max", "max"),
}


@dataclass
class MaterializedView:
    name: str
    source_table: str
    dimensions: List[str]  # group columns (time column included if bucketed)
    metrics: List[Tuple[str, str]]  # (agg function, source column) — count uses ("count", "*")
    time_column: Optional[str] = None
    bucket_ms: int = MS_DAY
    # bucket id -> set of source segment names that fed the last refresh
    fresh: Dict[int, Set[str]] = field(default_factory=dict)

    def mv_column(self, func: str, col: str) -> str:
        return f"{func}_{'star' if col == '*' else col}"

    def mv_schema(self, source_schema: Schema) -> Schema:
        fields: List[FieldSpec] = []
        for d in self.dimensions:
            f = source_schema.field(d)
            fields.append(FieldSpec(d, f.data_type, role=f.role))
        for func, col in self.metrics:
            fields.append(FieldSpec(self.mv_column(func, col), DataType.DOUBLE, role=FieldRole.METRIC))
        return Schema(name=self.name, fields=fields)


class MaterializedViewManager:
    def __init__(self, coordinator: Coordinator, broker: Optional[Broker] = None):
        self.coordinator = coordinator
        self.broker = broker or Broker(coordinator)
        self.views: Dict[str, MaterializedView] = {}

    # -- definition ------------------------------------------------------
    def create_view(self, mv: MaterializedView) -> None:
        src = self.coordinator.tables[mv.source_table]
        if mv.time_column and mv.time_column not in mv.dimensions:
            raise ValueError("the MV time column must be one of its dimensions")
        schema = mv.mv_schema(src.schema)
        cfg = TableConfig(name=mv.name, segments=SegmentsConfig(time_column=mv.time_column))
        self.coordinator.add_table(schema, cfg)
        self.views[mv.name] = mv

    # -- freshness -------------------------------------------------------
    def _bucket_of(self, ms: int, mv: MaterializedView) -> int:
        return int(ms) // mv.bucket_ms

    def _source_segments_for_bucket(self, mv: MaterializedView, bucket: int) -> Set[str]:
        meta = self.coordinator.tables[mv.source_table]
        out: Set[str] = set()
        lo = bucket * mv.bucket_ms
        hi = lo + mv.bucket_ms
        for name, sm in meta.segment_meta.items():
            tr = sm.get("timeRange")
            if mv.time_column is None or tr is None or tr[0] is None:
                out.add(name)
            elif tr[0] < hi and tr[1] >= lo:
                out.add(name)
        return out

    def stale_buckets(self, view_name: str) -> List[int]:
        """Buckets whose CURRENT source segment set differs from the set at
        their last refresh (the STALE marking of the reference)."""
        mv = self.views[view_name]
        buckets = self._all_source_buckets(mv)
        return [b for b in buckets if self.views[view_name].fresh.get(b) != self._source_segments_for_bucket(mv, b)]

    def _all_source_buckets(self, mv: MaterializedView) -> List[int]:
        meta = self.coordinator.tables[mv.source_table]
        if mv.time_column is None:
            return [0]
        buckets: Set[int] = set()
        for sm in meta.segment_meta.values():
            tr = sm.get("timeRange")
            if tr is not None and tr[0] is not None:
                for b in range(self._bucket_of(tr[0], mv), self._bucket_of(tr[1], mv) + 1):
                    buckets.add(b)
        return sorted(buckets)

    # -- refresh (minion task analog) ------------------------------------
    def refresh(self, view_name: str) -> Dict[str, object]:
        mv = self.views[view_name]
        refreshed = []
        for bucket in self.stale_buckets(view_name):
            self._refresh_bucket(mv, bucket)
            refreshed.append(bucket)
        return {"view": view_name, "refreshedBuckets": refreshed}

    def _refresh_bucket(self, mv: MaterializedView, bucket: int) -> None:
        dims = ", ".join(mv.dimensions)
        aggs = ", ".join(
            f"{func}({col})" if func != "count" else "COUNT(*)" for func, col in mv.metrics
        )
        where = ""
        if mv.time_column is not None:
            lo = bucket * mv.bucket_ms
            hi = lo + mv.bucket_ms
            where = f" WHERE {mv.time_column} >= {lo} AND {mv.time_column} < {hi}"
        sql = (
            f"SELECT {dims}, {aggs} FROM {mv.source_table}{where} "
            f"GROUP BY {dims} LIMIT 10000000"
        )
        res = self.broker.query(sql)
        nd = len(mv.dimensions)
        data: Dict[str, np.ndarray] = {}
        for i, d in enumerate(mv.dimensions):
            data[d] = np.asarray([r[i] for r in res.rows], dtype=object)
        for j, (func, col) in enumerate(mv.metrics):
            data[mv.mv_column(func, col)] = np.asarray(
                [float(r[nd + j]) for r in res.rows], dtype=np.float64
            )
        seg_name = f"{mv.name}__b{bucket}"
        meta = self.coordinator.tables[mv.name]
        if seg_name in meta.ideal:  # replace the bucket's old segment
            for s in meta.ideal.pop(seg_name):
                if s in self.coordinator.servers:
                    self.coordinator.servers[s].drop_segment(mv.name, seg_name)
            meta.segment_meta.pop(seg_name, None)
        if len(res.rows):
            seg = build_segment(meta.schema, data, seg_name, table_config=meta.config)
            self.coordinator.add_segment(mv.name, seg)
        mv.fresh[bucket] = self._source_segments_for_bucket(mv, bucket)

    # -- broker rewrite ---------------------------------------------------
    def rewrite(self, ctx: QueryContext) -> Optional[QueryContext]:
        """Rewritten context onto a fresh matching MV, or None (fallback)."""
        for mv in self.views.values():
            if mv.source_table != ctx.table:
                continue
            new_ctx = self._try_rewrite(ctx, mv)
            if new_ctx is not None:
                return new_ctx
        return None

    def _try_rewrite(self, ctx: QueryContext, mv: MaterializedView) -> Optional[QueryContext]:
        if not ctx.group_by or ctx.extra_aggregations or ctx.having or ctx.set_ops:
            return None
        if not all(g.is_column and g.op in mv.dimensions for g in ctx.group_by):
            return None
        if ctx.filter is not None:
            for p in ctx.filter.predicates():
                if not (p.lhs.is_column and p.lhs.op in mv.dimensions):
                    return None
        available = {(f, c) for f, c in mv.metrics}
        new_select = []
        for s in ctx.select_list:
            if isinstance(s, AggregationSpec):
                if s.filter is not None or s.literal_args:
                    return None
                func = s.function
                col = "*" if s.expr is None else (s.expr.op if s.expr.is_column else None)
                if col is None or func not in _AGG_MAP or (func, col) not in available:
                    return None
                _, combine = _AGG_MAP[func]
                new_select.append(AggregationSpec(combine, Expr.col(mv.mv_column(func, col))))
            elif isinstance(s, Expr) and s.is_column and s.op in mv.dimensions:
                new_select.append(s)
            else:
                return None
        # freshness: every bucket the query could touch must be fresh
        if self.stale_buckets(mv.name):
            return None
        import dataclasses

        return dataclasses.replace(
            ctx,
            table=mv.name,
            select_list=new_select,
            select_aliases=list(ctx.select_aliases),
        )

    # -- query front door --------------------------------------------------
    def query(self, sql: str):
        """Broker query with MV rewrite (the reference's broker hook)."""
        from pinot_tpu_torch.sql.parser import parse_query

        ctx = parse_query(sql)
        rewritten = self.rewrite(ctx)
        res = self.broker.execute(rewritten if rewritten is not None else ctx)
        res.stats.mv_rewrite = rewritten is not None  # type: ignore[attr-defined]
        return res
