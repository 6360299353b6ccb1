"""In-process query engine: table registry + execute (broker + server in one).

Port of pinot_tpu/query/engine.py for single-table SQL on one device:
register_table / add_segment / execute / query.  Execution is pipelined as
in the JAX package — every segment's work is launched (queued on the CUDA
stream) before the first result is collected — then the host reduce runs.

Schema evolution: before a segment is planned, `ensure_columns` gives it
the TABLE schema's fields that it lacks (older segments read them as SQL
NULL), and `SELECT *` covers the table schema.  Every query is recorded in
the process perf ledger (utils/perf.PERF_LEDGER: rows/s and the analytic
kernel bytes/s per table and shape), which the residency tier reads as
eviction heat.

``QueryEngine(device=None)`` runs on CUDA and raises without it;
``device="cpu"`` runs the plain PyTorch path.  Aggregations, group-bys
(over columns and expressions, with FILTER (WHERE ...)), and selections
(columns, expressions, ORDER BY, OFFSET, window functions) run; EXPLAIN,
subqueries, set operations, joins and gap-filling are later slices of the
port.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.query import executor, planner, reduce as reduce_mod
from pinot_tpu_torch.query.ir import Expr, QueryContext
from pinot_tpu_torch.query.result import ExecutionStats, ResultTable
from pinot_tpu_torch.query.shape import shape_digest
from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.spi.config import TableConfig
from pinot_tpu_torch.spi.schema import Schema
from pinot_tpu_torch.utils import perf


@dataclass
class TableState:
    schema: Schema
    config: TableConfig
    segments: List[ImmutableSegment] = field(default_factory=list)


class QueryEngine:
    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.tables: Dict[str, TableState] = {}
        self._qid_seq = itertools.count(1)

    # -- table registry (controller-lite) -------------------------------
    def register_table(self, schema: Schema, config: Optional[TableConfig] = None) -> None:
        cfg = config or TableConfig(name=schema.name)
        self.tables[cfg.name] = TableState(schema=schema, config=cfg)

    def add_segment(self, table: str, segment: ImmutableSegment) -> None:
        self.tables[table].segments.append(segment)

    def table(self, name: str) -> TableState:
        if name not in self.tables:
            raise KeyError(f"table {name!r} not registered (have {list(self.tables)})")
        return self.tables[name]

    # -- execution -------------------------------------------------------
    def execute(self, ctx: QueryContext) -> ResultTable:
        if ctx.joins or ctx.set_ops or ctx.gapfill is not None:
            raise NotImplementedError(
                "joins, set operations and gap-filling are later slices of the port"
            )
        t0 = time.perf_counter()
        state = self.table(ctx.table)
        stats = ExecutionStats()
        star = any(isinstance(s, Expr) and s.is_column and s.op == "*" for s in ctx.select_list)
        pending = []
        for seg in state.segments:
            stats.num_segments_queried += 1
            stats.total_docs += seg.num_docs
            # schema evolution: fields added to the table schema after this
            # segment was built read as NULL; SELECT * covers the FULL table
            # schema, not the segment's
            needed = planner._needed_columns(ctx, seg)
            if star:
                needed = list(dict.fromkeys(list(needed) + state.schema.column_names))
            seg.ensure_columns(state.schema, needed)
            if executor.prune_segment(ctx, seg):
                stats.num_segments_pruned += 1
                continue
            pending.append(executor.launch_segment(ctx, seg, self.device))
        results = []
        for st in pending:
            res, seg_stats = executor.collect_segment(st)
            stats.num_segments_processed += 1
            stats.num_docs_scanned += seg_stats.num_docs_scanned
            stats.add_index_uses(seg_stats.filter_index_uses)
            stats.bytes_to_host += seg_stats.bytes_to_host
            stats.kernel_bytes += seg_stats.kernel_bytes
            results.append(res)
        out = reduce_mod.reduce_results(ctx, results, stats)
        out.stats.time_ms = (time.perf_counter() - t0) * 1000
        out.stats.query_id = f"engine_{next(self._qid_seq)}"
        perf.PERF_LEDGER.record(
            ctx.table,
            shape_digest(ctx.shape_fingerprint()),
            rows=out.stats.num_docs_scanned,
            time_ms=out.stats.time_ms,
            kernel_bytes=out.stats.kernel_bytes,
            engine="sse",  # no compile step and no plan-cache outcome on this engine
        )
        return out

    def query(self, sql: str) -> ResultTable:
        """SQL front door."""
        from pinot_tpu_torch.sql.parser import parse_query

        return self.execute(parse_query(sql))
