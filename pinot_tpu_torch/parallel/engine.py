"""Distributed query engine over a mesh of device positions: macro-batched
launches over a StackedTable.

Port of pinot_tpu/parallel/engine.py's DistributedEngine.  A query plans
ONCE over the whole stacked table (plan cache keyed by the query's shape
fingerprint, the table's signature, the mesh size, the batch width and the
backend tag "cuda" | "torch"), and its closure runs once per macro-batch
and mesh position: each launch covers doc columns [off, off + batch_docs)
of the position's shards, position p holding shards [p * L, (p + 1) * L)
of the [S, D] column arrays (parallel/mesh.py; one Python process drives
every position, and positions may share one device).  The JAX package's
in-graph psum over the mesh is a fold here: a launch's per-position
partials fold in global position order on the first position's device
(float adds by mesh.psum_ordered, integer adds and min / max by the
hierarchical folds, coupled partials by the function's pairwise merge),
then the launches fold (dense and scalar tables add / min / max, sparse
tables, every position's in position order, through
ops.sparse_merge.merge_sparse_tables), and one copy brings the result home.
`DistributedEngine(device=...)` is a mesh of one position on that device.

The range-index words of a filter that is one plain bitmap go straight to
the fused scan (`mask_words`, the word-fused path): no row mask is unpacked.
Aggregation inputs may be expressions and carry FILTER (WHERE ...) masks,
which ride the word-fused path beside the words; group keys may be "expr" or
"derived" dimensions.  Up to `pipeline_depth` launches are in flight before
the first drain, which waits on that launch's completion event, not on the
whole stream.

Selection queries take the JAX engine's shape: bare select columns and bare
ORDER BY columns only (expression items and window functions are refused,
as there).  Each launch's row mask turns into global doc ids on the device,
only the fresh part of a re-covering tail window counting, and only the ids
come home; the rows gather on the host (StackedTable.decoded_rows).

Residency (segment/residency.py): by default the table's doc slices live
in a byte-budgeted device cache (`default_residency()`: 8 GiB, or
PINOT_TPU_HBM_CACHE_BYTES; `hbm_cache_bytes=` / `residency=` set it, 0
turns it off).  With it, batch k+1's slices and range-index words stage on
the residency manager's one staging thread while batch k scans, evicting
cost-ranked slices when the budget is full; on CUDA that thread copies on
the engine's own stream from pinned memory (parallel/staging.py) and the
launch waits on the batch's copy event.  Without it (hbm_cache_bytes=0)
every batch stages before the first launch on the compute stream, with
pageable copies: the untiered path the tiered one is held against.

Every query is counted (`dist.queries`, `dist.queryLatency`) and recorded
in the perf ledger (utils/perf.PERF_LEDGER) with its analytic kernel bytes.

Sketch and extended aggregations bind on the stacked table, which has one
dictionary per column, so "dict" bindings are always aligned
(`_inject_sketch_info`).  Their partials combine across macro-batches on
the device before the one copy home: vector fields by their names' max /
add, and the coupled partials (KMV, tuple sketches, (t, v), (m, v)) by the
function's pairwise merge, on device tensors.  The JAX engine refuses the
pairwise ones outside the sparse path (its in-graph psum cannot take
them); this engine has no psum and merges them like the segment engine.

Multi-value columns take ANY-semantics filters and the *MV aggregations
here; an MV GROUP BY (the explode) raises NotImplementedError, as the JAX
engine's does.  The stacked table holds no star-tree, JSON, text or vector
index (as in the JAX package).

GAPFILL runs here as on the segment engine: the shared reduce fills the
reduced group-by rows.  A query run with `SET trace = true` carries `plan`
(its shape digest and plan-cache outcome), `run` and `reduce` spans, as the
JAX engine's does.

A query with JOIN clauses goes to the multi-stage engine
(mse.MultiStageEngine), built at first use over this engine's table
registry, device and residency manager, as the JAX engine routes it.

Cross-query batching (`execute_many`): same-shape queries run as one
torch.func.vmap of their shared closure, the fused scan's member-axis
launch, under the JAX engine's eligibility rule.  A malformed query raises
PlanCheckError before planning (analysis/plan_check.py); plans are cached
in the named LRU "compile.dist" and the batched closures in
"compile.batch.dist" (utils/cache.py).

ReplicatedEngine (below) serves QPS from a 2-D mesh: one engine a replica
row, each row a full copy of the data under its own residency budget.

Refused with NotImplementedError, each a reference fault (ROADMAP Queue 3):
set operations and EXPLAIN / EXPLAIN ANALYZE, which the JAX engine ignores
(it answers the first component, or runs the query), and IN (SELECT ...),
on which it faults with a TypeError; the broker (cluster/broker.py) routes
them over ServerInstances in both packages.
"""
from __future__ import annotations

import concurrent.futures
import itertools
import os
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.analysis.compile_audit import DIST_AUDIT
from pinot_tpu_torch.analysis.plan_check import check_plan_cached
from pinot_tpu_torch.cluster.admission import current_pressure_level, pipeline_depth_under_pressure
from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.ops.sparse_merge import merge_sparse_tables
from pinot_tpu_torch.parallel import mesh as mesh_mod
from pinot_tpu_torch.query import executor, planner
from pinot_tpu_torch.query import reduce as reduce_mod
from pinot_tpu_torch.query.filter import FilterCompiler
from pinot_tpu_torch.query.functions import FIELD_COMBINE, combine_field, for_spec
from pinot_tpu_torch.query.ir import Expr, FilterNode, FilterOp, QueryContext, Subquery
from pinot_tpu_torch.query.planner import GroupDim
from pinot_tpu_torch.query.result import (
    AggSegmentResult,
    DenseGroupData,
    ExecutionStats,
    GroupBySegmentResult,
    ResultTable,
    SelectionSegmentResult,
)
from pinot_tpu_torch.query.shape import column_info_from, params_structure, shape_digest
from pinot_tpu_torch.segment.residency import default_residency
from pinot_tpu_torch.utils import perf
from pinot_tpu_torch.utils.cache import LruCache
from pinot_tpu_torch.utils.metrics import METRICS, Trace


# the launch schedule's params: a launch's first doc column, and its first
# column not covered by an earlier launch
_SCHEDULE_PARAMS = ("__boff__", "__fresh__")


def _has_subquery(node: Optional[FilterNode]) -> bool:
    if node is None:
        return False
    if node.op is FilterOp.PRED:
        return any(isinstance(v, Subquery) for v in node.predicate.values or ())
    return any(_has_subquery(c) for c in node.children)


def flatten_cols(cols):
    """[S, D, ...] shard-local row tensors -> flat [S * D, ...] views (MV
    code matrices keep their trailing element axis)."""
    out = {}
    for name, entry in cols.items():
        out[name] = {
            k: (v.reshape((-1,) + tuple(v.shape[2:])) if k in ("codes", "codes_packed", "values", "nulls", "lengths")
                else v)
            for k, v in entry.items()
        }
    return out


class _ShardView:
    """Plan-time facade over a StackedTable for the FilterCompiler and the
    planner helpers: they read metadata (dictionaries, nulls, dtypes, stats)
    and num_docs, here the flat row count of ONE launch (local shards x
    batch docs).  `docs_fn` gives the global flat doc ids of a launch's rows
    and `bitmap_layout` the full-words shape [ndev, L, D // 32] of index
    bitmap params (query/filter.py)."""

    def __init__(
        self,
        stacked,
        local_rows: int,
        docs_fn: Optional[Callable] = None,
        bitmap_layout: Optional[Tuple[int, int, int]] = None,
    ):
        self._stacked = stacked
        self.num_docs = local_rows
        self.schema = stacked.schema
        self.total_docs = stacked.num_docs
        self.indexes = stacked.indexes
        self.docs_fn = docs_fn
        self.bitmap_layout = bitmap_layout

    def column(self, name: str):
        return self._stacked.column(name)


@dataclass
class _DistPlan:
    kind: str  # aggregation | groupby_dense | groupby_sparse | selection
    fn: Callable  # fn(cols, params, dev) -> one launch's outputs (selection: the row mask)
    params: Dict[str, Any]
    needed_columns: List[str]
    aggs: List[Any]
    group_dims: List[GroupDim]
    num_groups: int
    # param keys sliced on the doc axis per launch (index bitmap words)
    row_sharded_params: frozenset = frozenset()
    # (column, index kind) per index-accelerated filter predicate
    index_uses: Tuple = ()
    # macro-batch launch schedule: each launch covers doc columns [off,
    # off + batch_docs) of the [S, D] arrays; `fresh` is the first not yet
    # covered column within the batch (tail overlap masking)
    batch_docs: int = 0
    batch_offsets: Tuple[Tuple[int, int], ...] = ((0, 0),)
    # device-side cross-launch merge of the sparse path; None merges on the host
    sparse_merge_fn: Optional[Callable] = None
    # the filter's words go straight to the fused scan (mask_words)
    word_fused: bool = False
    select_columns: Tuple[str, ...] = ()
    # flat docs one mesh position holds (L shards x D): a launch's global
    # doc base is position * position_docs + off
    position_docs: int = 0


class DistributedEngine:
    """Executes queries over StackedTables on a mesh of device positions.

    mesh: a parallel.mesh.Mesh (1-D, or 2-D in capacity mode: rows shard
    over both axes); None is one position on `device`, where None means
    CUDA and raises without it and "cpu" runs the plain PyTorch path
    (mesh.default_mesh() is every visible card).  A table's num_shards must
    divide by the mesh size.  launch_bytes: the bytes of table one launch
    may cover on one position (macro-batching threshold, default
    PINOT_TPU_LAUNCH_BYTES or 2 GiB).
    pipeline_depth: launches in flight before the first drain, and batches
    staged ahead; None reads the autopilot's `pipeline_depth` knob at each
    query (PINOT_TPU_PIPELINE_DEPTH, default 2), a value pins it.
    residency: a caller-owned ResidencyManager; else hbm_cache_bytes > 0
    makes one of that budget, 0 turns tiering off, and None takes
    default_residency() (8 GiB unless PINOT_TPU_HBM_CACHE_BYTES says
    otherwise), as in the JAX package."""

    def __init__(
        self,
        device: DeviceLike = None,
        launch_bytes: Optional[int] = None,
        pipeline_depth: Optional[int] = None,
        hbm_cache_bytes: Optional[int] = None,
        residency=None,
        mesh: Optional[mesh_mod.Mesh] = None,
    ):
        if mesh is None:
            mesh = mesh_mod.Mesh([resolve_device(device)], (mesh_mod.SEG_AXIS,))
        elif device is not None:
            raise ValueError("pass a mesh or a device, not both")
        self.mesh = mesh
        # every position's device in global order; the first is home: the
        # folds and the copies home run there
        self.positions: List[torch.device] = mesh.positions
        self.device = self.positions[0]
        self.tables: Dict[str, Any] = {}
        # plan-cache bytes charge the process host ledger the admission
        # controller tracks (cluster/admission.py)
        from pinot_tpu_torch.cluster.admission import process_host_budget

        self._plan_cache = LruCache(
            max_entries=planner._plan_cache_entries(), name="compile.dist", budget=process_host_budget()
        )
        # execute_many's batched closures (torch.func.vmap of a plan's
        # closure, made once), keyed on the base closure
        self._batch_fn_cache = LruCache(max_entries=32, name="compile.batch.dist")
        # plan-cache misses (plans built) and hits since construction
        self.plan_misses = 0
        self.plan_hits = 0
        self.launch_bytes = (
            launch_bytes if launch_bytes is not None
            else int(os.environ.get("PINOT_TPU_LAUNCH_BYTES", str(2 << 30)))
        )
        self._pipeline_depth_override: Optional[int] = None if pipeline_depth is None else int(pipeline_depth)
        self._qid_seq = itertools.count(1)
        if residency is not None:
            self.residency = residency
        elif hbm_cache_bytes is not None and hbm_cache_bytes > 0:
            from pinot_tpu_torch.cluster.admission import ResourceBudget

            self.residency = default_residency(
                budget=ResourceBudget(hbm_cache_bytes, gauge="residency.reservedBytes")
            )
        elif hbm_cache_bytes is not None:
            self.residency = None
        else:
            self.residency = default_residency()
        # the tiered path's CUDA copy stream and pinned ring of each card
        # (made at first use), keyed by str(device)
        self._copy_streams: Dict[str, Any] = {}
        self._mse_engine = None

    @property
    def pipeline_depth(self) -> int:
        """In-flight launch depth, read per launch loop (the autopilot's
        KnobRegistry unless pinned by the ctor or an assignment)."""
        if self._pipeline_depth_override is not None:
            return self._pipeline_depth_override
        from pinot_tpu_torch.cluster import autopilot

        return int(autopilot.knobs().get("pipeline_depth"))

    @pipeline_depth.setter
    def pipeline_depth(self, value: int) -> None:
        self._pipeline_depth_override = int(value)

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def register_table(self, name: str, stacked) -> None:
        if stacked.num_shards % self.num_devices:
            raise ValueError(f"num_shards={stacked.num_shards} not divisible by mesh size {self.num_devices}")
        self.tables[name] = stacked
        # drop stale self-join facades of a re-registered table (mse/plan.py
        # resolve registers them as '{name}@{alias}')
        for k in [k for k in self.tables if k.startswith(name + "@")]:
            del self.tables[k]

    def _mse(self):
        """The multi-stage engine join queries go to, over the same table
        registry, mesh and residency manager (built at first use)."""
        if self._mse_engine is None:
            from pinot_tpu_torch.mse.engine import MultiStageEngine

            self._mse_engine = MultiStageEngine(mesh=self.mesh, tables=self.tables, residency=self.residency)
        return self._mse_engine

    # ------------------------------------------------------------------
    def query(self, sql: str) -> ResultTable:
        from pinot_tpu_torch.sql.parser import parse_query

        return self.execute(parse_query(sql))

    def execute(self, ctx: QueryContext) -> ResultTable:
        if ctx.joins:
            return self._mse().execute(ctx)
        if ctx.set_ops:
            raise NotImplementedError(
                "set operations on the distributed engine: the JAX engine ignores them and answers the "
                "first component (a reference fault, ROADMAP Queue 3); run them on the segment engine"
            )
        if ctx.options.get("__explain__") or ctx.options.get("__analyze__"):
            raise NotImplementedError(
                "EXPLAIN on the distributed engine: the JAX engine ignores it and runs the query "
                "(a reference fault, ROADMAP Queue 3); run it on the segment engine"
            )
        if _has_subquery(ctx.filter) or _has_subquery(ctx.having):
            raise NotImplementedError(
                "IN (SELECT ...) on the distributed engine: the JAX engine fails on it with a TypeError "
                "(a reference fault, ROADMAP Queue 3); run it on the segment engine"
            )
        t0 = time.perf_counter()
        trace = Trace(bool(ctx.options.get("trace", False)))
        if ctx.table not in self.tables:
            raise KeyError(f"table {ctx.table!r} not registered (have {list(self.tables)})")
        stacked = self.tables[ctx.table]
        self._inject_sketch_info(ctx, stacked)
        stats = ExecutionStats(
            num_segments_queried=stacked.num_shards,
            num_segments_processed=stacked.num_shards,
            num_docs_scanned=stacked.num_docs,
            total_docs=stacked.num_docs,
        )
        misses = self.plan_misses
        shape_fp = ctx.shape_fingerprint(column_info_from(stacked))
        with trace.span("plan") as psp:
            plan = self._plan(ctx, stacked)
            cache_hit = self.plan_misses == misses
            if psp is not None:
                psp.annotate(shapeFp=shape_digest(shape_fp), planCache="hit" if cache_hit else "miss")
        if not cache_hit:
            stats.compile_ms = (time.perf_counter() - t0) * 1000.0
        stats.add_index_uses(plan.index_uses)
        with trace.span("run"):
            result = self._run(ctx, plan, stacked, stats, trace)
        with trace.span("reduce"):
            out = reduce_mod.reduce_results(ctx, [result], stats)
        out.stats.trace = trace.finish()
        out.stats.time_ms = (time.perf_counter() - t0) * 1000
        out.stats.query_id = f"dist_{next(self._qid_seq)}"
        METRICS.counter("dist.queries").inc()
        METRICS.histogram("dist.queryLatency").update(out.stats.time_ms)
        perf.PERF_LEDGER.record(
            ctx.table,
            shape_digest(shape_fp),
            rows=out.stats.num_docs_scanned,
            time_ms=out.stats.time_ms,
            kernel_bytes=out.stats.kernel_bytes,
            compile_ms=out.stats.compile_ms,
            cache_hit=cache_hit,
            engine="dist",
        )
        return out

    def execute_many(self, ctxs: List[QueryContext]) -> List[ResultTable]:
        """Cross-query batching: queries that share one planned closure run
        as ONE torch.func.vmap of it, their literal params stacked on a
        leading member axis (the fused scan's member-axis launch).

        Eligibility is the JAX engine's, kept narrow: aggregation or dense
        group-by plans with no row-sharded bitmap params and a single
        macro-batch.  Ineligible queries, singleton groups and any group
        whose batched attempt fails (counted in dist.batchFallbacks) run
        through execute() one by one, so results always match the
        unbatched path.  Queries execute() refuses go to it as they are."""
        results: List[Optional[ResultTable]] = [None] * len(ctxs)
        groups: Dict[Any, List[int]] = {}
        for i, ctx in enumerate(ctxs):
            if (ctx.joins or ctx.set_ops or ctx.table not in self.tables or ctx.options.get("__explain__")
                    or ctx.options.get("__analyze__") or _has_subquery(ctx.filter) or _has_subquery(ctx.having)):
                results[i] = self.execute(ctx)
                continue
            stacked = self.tables[ctx.table]
            key = (ctx.table, shape_digest(ctx.shape_fingerprint(column_info_from(stacked))))
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            outs = self._execute_group([ctxs[i] for i in idxs]) if len(idxs) > 1 else None
            if outs is None:
                for i in idxs:
                    results[i] = self.execute(ctxs[i])
            else:
                for i, o in zip(idxs, outs):
                    results[i] = o
        return results

    def _execute_group(self, ctxs: List[QueryContext]) -> Optional[List[ResultTable]]:
        """One batched launch for a same-shape group; None = not eligible or
        the attempt failed (the caller executes the members one by one)."""
        table = ctxs[0].table
        stacked = self.tables[table]
        n = len(ctxs)
        t0 = time.perf_counter()
        try:
            for ctx in ctxs:
                self._inject_sketch_info(ctx, stacked)
            plans = [self._plan(ctx, stacked) for ctx in ctxs]
            base = plans[0]
            if any(p.fn is not base.fn for p in plans[1:]):
                return None
            if base.kind not in ("aggregation", "groupby_dense"):
                return None
            if base.row_sharded_params or len(base.batch_offsets) != 1:
                return None
            if n > executor.batch_width():
                return None
            if self.num_devices > 1 and any(fn.pairwise_merge for fn in base.aggs):
                return None  # coupled partials of W members do not fold across positions
            staged = [self._await_staged(*item, dev)
                      for item, dev in zip(self._stage_batch(base, stacked, 0, {}), self.positions)]
            # launch-schedule ints: one schedule for every member
            axes = {k: None if k in _SCHEDULE_PARAMS else 0 for k in base.params}
            members = {k: np.stack([executor.param_array(p.params[k]) for p in plans])
                       for k, ax in axes.items() if ax == 0}
            on_device: Dict[str, Dict[str, torch.Tensor]] = {}
            fnb = self._batch_fn_cache.get(base.fn)
            first_batched = fnb is None
            if first_batched:
                fnb = torch.func.vmap(base.fn, in_dims=(None, axes, None))
                self._batch_fn_cache.put(base.fn, fnb)
                executor.BATCH_AUDIT.record_compile()
            else:
                executor.BATCH_AUDIT.record_hit()
            td0 = time.perf_counter()
            outs = []
            for (cols, params), dev in zip(staged, self.positions):
                if str(dev) not in on_device:
                    on_device[str(dev)] = {k: torch.from_numpy(v).to(dev) for k, v in members.items()}
                outs.append(fnb(cols, {**params, **on_device[str(dev)]}, dev))
            # _to_host copies the folded tables home: the fence before the stop
            host = executor._to_host(self._fold_launch(base, outs))
            run_ms = (time.perf_counter() - td0) * 1000.0  # pinot-lint: disable=W017
        except Exception:  # noqa: BLE001 — a failed attempt runs the members one by one
            METRICS.counter("dist.batchFallbacks").inc()
            return None
        compile_ms = run_ms if first_batched else 0.0
        kernel_bytes = stacked.num_shards * base.batch_docs * perf.analytic_bytes_per_row(
            stacked.column(nm) for nm in base.needed_columns
        )
        share, rem = divmod(stacked.num_docs, n)
        shim = SimpleNamespace(group_dims=base.group_dims, aggs=base.aggs)
        outs = []
        for i, (ctx, plan) in enumerate(zip(ctxs, plans)):
            member = executor._member(host, i)
            stats = ExecutionStats(
                num_segments_queried=stacked.num_shards,
                num_segments_processed=stacked.num_shards,
                num_docs_scanned=share + (1 if i < rem else 0),
                total_docs=stacked.num_docs,
            )
            stats.add_index_uses(plan.index_uses)
            stats.kernel_bytes = kernel_bytes / n
            if i == 0 and compile_ms:
                stats.compile_ms = compile_ms
            if base.kind == "aggregation":
                result = AggSegmentResult(partials=[fn.host_partial(p) for fn, p in zip(base.aggs, member)])
            else:
                presence, partials = member
                keys, sliced = executor._dense_to_present(
                    shim, presence, partials, ctx.num_groups_limit,
                    order_trim=planner.order_by_agg_index(ctx),
                )
                stats.num_groups = len(keys[0]) if keys else 0
                result = GroupBySegmentResult(
                    keys=keys, partials=sliced,
                    dense=DenseGroupData(
                        presence=presence, partials=partials, key_space=executor._key_space_id(shim),
                        group_dims=base.group_dims,
                    ),
                )
            out = reduce_mod.reduce_results(ctx, [result], stats)
            out.stats.time_ms = (time.perf_counter() - t0) * 1000  # pinot-lint: disable=W017
            out.stats.query_id = f"dist_{next(self._qid_seq)}"
            METRICS.counter("dist.queries").inc()
            METRICS.histogram("dist.queryLatency").update(out.stats.time_ms)
            perf.PERF_LEDGER.record(
                ctx.table,
                shape_digest(ctx.shape_fingerprint(column_info_from(stacked))),
                rows=out.stats.num_docs_scanned,
                time_ms=out.stats.time_ms,
                kernel_bytes=out.stats.kernel_bytes,
                compile_ms=out.stats.compile_ms,
                cache_hit=not first_batched,
                engine="dist",
            )
            outs.append(out)
        METRICS.counter("dist.batches").inc()
        METRICS.histogram("dist.batchSize").update(n)
        return outs

    @staticmethod
    def _inject_sketch_info(ctx: QueryContext, stacked) -> None:
        """Stacked tables are aligned by construction (one dictionary per
        column): publish that, the dictionary values and the global range
        for the sketch bindings (planner.column_binding)."""
        for spec in ctx.aggregations:
            if spec.expr is None or not spec.expr.is_column:
                continue
            if not for_spec(spec).needs_binding:
                continue
            col = spec.expr.op
            c = stacked.column(col)
            ctx.options.setdefault(f"__dictfp__{col}", c.dictionary.fingerprint() if c.has_dictionary else "")
            if c.has_dictionary:
                ctx.options.setdefault(f"__dictvals__{col}", c.dictionary.values)
            if c.stats.min_value is not None and not c.data_type.is_string_like:
                ctx.options.setdefault(f"__range__{col}", (c.stats.min_value, c.stats.max_value))

    # ------------------------------------------------------------------
    def _plan(self, ctx: QueryContext, stacked) -> _DistPlan:
        check_plan_cached(ctx)
        batch_docs, batch_offsets = self._batching(ctx, stacked)
        # keyed on the SHAPE fingerprint: predicate literals are parameter
        # slots, so distinct-literal variants of one query share the entry
        # and only rebind params
        key = (
            ctx.shape_fingerprint(column_info_from(stacked)),
            stacked.signature(), self.num_devices, batch_docs,
            planner.backend_tag(self.device),
        )
        cached = self._plan_cache.get(key)
        if cached is not None:
            plan = self._build_plan(ctx, stacked, batch_docs, batch_offsets, cached=cached)
            if (
                params_structure(plan.params) == params_structure(cached.params)
                and plan.row_sharded_params == cached.row_sharded_params
            ):
                self.plan_hits += 1
                DIST_AUDIT.record_hit(key[0])
                return plan
        self.plan_misses += 1
        DIST_AUDIT.record_compile(key[0])
        plan = self._build_plan(ctx, stacked, batch_docs, batch_offsets)
        self._plan_cache.put(key, plan)
        return plan

    def _batching(self, ctx: QueryContext, stacked) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
        """Macro-batch launch schedule, the JAX package's arithmetic: the
        doc axis splits into enough 32-aligned windows that one launch
        covers at most launch_bytes of the table; a ragged tail re-launches
        the last full-width window with the already covered rows masked via
        the `fresh` offset."""
        D = stacked.docs_per_shard
        L = stacked.num_shards // self.num_devices
        # bytes per doc over the WHOLE table (not the query's columns): every
        # query shares one doc slicing, so no column is cached twice
        bytes_per_doc = 0.0
        for c in stacked.columns.values():
            if c.codes is not None:  # an MV code matrix counts its element slots
                bytes_per_doc += (c.code_bits / 8.0 if c.code_bits and c.packed is not None
                                  else c.codes.dtype.itemsize * int(np.prod(c.codes.shape[2:])))
            if c.values is not None:
                bytes_per_doc += c.values.dtype.itemsize
            if c.nulls is not None:
                bytes_per_doc += 1
            if c.mv_lengths is not None:
                bytes_per_doc += c.mv_lengths.dtype.itemsize
        per_dev = int(max(1.0, bytes_per_doc) * L * D)
        n_batches = max(1, -(-per_dev // self.launch_bytes))
        if n_batches == 1 or D < 64:
            return D, ((0, 0),)
        batch_docs = min(D, -(-(-(-D // n_batches)) // 32) * 32)
        offsets = []
        off = 0
        while off + batch_docs <= D:
            offsets.append((off, 0))
            off += batch_docs
        if off < D:
            tail = D - batch_docs
            offsets.append((tail, off - tail))
        return batch_docs, tuple(offsets)

    def _build_plan(
        self,
        ctx: QueryContext,
        stacked,
        batch_docs: int,
        batch_offsets: Tuple[Tuple[int, int], ...],
        cached: Optional[_DistPlan] = None,
    ) -> _DistPlan:
        """Plan one query over the stacked table.  With `cached` (a plan
        cache hit) only the params and metadata are rebuilt; the closure and
        the merge function are the cached plan's."""
        ndev = self.num_devices
        L = stacked.num_shards // ndev
        D_full = stacked.docs_per_shard
        Db = batch_docs
        local_rows = L * Db
        has_padding = stacked.num_docs < stacked.num_shards * D_full
        backend = planner.backend_tag(self.device)
        assert D_full % 32 == 0, "docs_per_shard must be 32-aligned (StackedTable.build)"

        def docs_fn(params, dev):
            """Global flat doc ids of this launch's rows."""
            return (
                params["__boff__"]
                + torch.arange(L, dtype=torch.int32, device=dev)[:, None] * D_full
                + torch.arange(Db, dtype=torch.int32, device=dev)[None, :]
            ).reshape(-1)

        def _valid_mask(params, dev):
            """Padding rows and the tail window's already covered columns
            masked off; None when the launch has neither."""
            m = None
            if has_padding:
                m = docs_fn(params, dev) < stacked.num_docs
            fresh = params["__fresh__"]
            if fresh:
                f = torch.ones(Db, dtype=torch.bool, device=dev)
                f[:fresh] = False
                f = f.repeat(L)
                m = f if m is None else m & f
            return m

        view = _ShardView(stacked, local_rows, docs_fn=docs_fn, bitmap_layout=(ndev, L, D_full // 32))
        fc = FilterCompiler(view, ctx.null_handling)
        filter_fn = fc.compile(ctx.filter)
        # set when the WHOLE filter is one plain index bitmap (read before
        # the FILTER clauses below compile through the same compiler)
        word_key = fc.sole_bitmap_param
        agg_specs = list(ctx.aggregations)
        aggs = planner.bind_aggs(agg_specs, stacked, ctx)
        agg_filter_fns = [fc.compile(s.filter) if s.filter is not None else None for s in agg_specs]
        agg_subfilter_fns = planner.compile_subfilters(fc, aggs)

        kind, group_dims, num_groups = planner.plan_groups(ctx, view, aggs)
        if any(gd.mv for gd in group_dims):
            raise NotImplementedError("MV GROUP BY (explode) is not yet supported on the distributed stacked path")
        select_columns: List[str] = []
        if kind == "selection":
            for s in ctx.select_list:
                if not (isinstance(s, Expr) and s.is_column):
                    raise NotImplementedError(
                        f"selection item {s} on the distributed engine: only bare columns, as in the JAX package"
                    )
                select_columns.extend(stacked.schema.column_names if s.op == "*" else [s.op])
            if any(not o.expr.is_column for o in ctx.order_by):
                raise NotImplementedError("selection ORDER BY on the distributed engine supports bare columns only")
            mv = [c for c in select_columns + [o.expr.op for o in ctx.order_by]
                  if c in stacked.columns and stacked.columns[c].is_multi_value]
            if mv:
                # the JAX engine has no MV row gather either (it faults with
                # an IndexError, or orders by a padded code matrix)
                raise NotImplementedError(
                    f"selection of multi-value column {mv[0]} on the distributed engine, as in the JAX package"
                )
        needed = planner._needed_columns(ctx, stacked)
        packed_meta = planner.packed_code_bits(stacked, needed)

        def _flat(cols):
            return planner.overlay_unpacked(flatten_cols(cols), packed_meta, local_rows)

        _agg_inputs = planner.make_agg_inputs(
            agg_specs, aggs, agg_filter_fns, view, ctx.null_handling, agg_subfilter_fns)

        def _filtered(cols, params, dev):
            """The filter's row mask, padding and covered tail rows off."""
            tmask, _ = filter_fn(cols, params, dev)
            vm = _valid_mask(params, dev)
            return tmask if vm is None else tmask & vm

        sparse_merge_fn = None
        word_fused = False

        if kind == "aggregation":

            def kernel(cols, params, dev):
                cols = _flat(cols)
                tmask = _filtered(cols, params, dev)
                return [fn.partial(v, m) for fn, (v, m) in zip(aggs, _agg_inputs(cols, params, tmask, dev))]

        elif kind == "selection":

            def kernel(cols, params, dev):
                return _filtered(_flat(cols), params, dev)

        elif kind == "groupby_dense":
            vranges = planner.agg_vranges(agg_specs, stacked)
            # word fusion: the whole filter is one plain index bitmap and
            # every field is one the fused scan makes (count/sum/sumsq), so
            # the packed words go straight to the scan
            word_fused = word_key is not None and planner.words_fusable(aggs)

            def kernel(cols, params, dev):
                cols = _flat(cols)
                if word_fused:
                    vm = _valid_mask(params, dev)
                    tmask = vm if vm is not None else torch.ones(local_rows, dtype=torch.bool, device=dev)
                    words = params[word_key].reshape(-1)
                else:
                    tmask = _filtered(cols, params, dev)
                    words = None
                return planner.grouped_partials(
                    aggs, _agg_inputs(cols, params, tmask, dev), tmask,
                    planner.lazy_group_key(cols, group_dims, view, dev), num_groups,
                    vranges, backend=backend, mask_words=words,
                    key_packed=planner.key_packed(cols, group_dims, packed_meta, local_rows, backend),
                )

        else:  # groupby_sparse
            # per-launch sort + scatter into fixed [num_slots] tables; only
            # tables, never row-length arrays, outlive a launch.  Each launch
            # keeps its local top num_slots groups by the ORDER BY comparator
            tables, num_slots, order_spec = planner.sparse_tables_fn(
                ctx, aggs, group_dims, num_groups, _agg_inputs, view)

            def kernel(cols, params, dev):
                cols = _flat(cols)
                return tables(cols, params, _filtered(cols, params, dev), dev)

            # device merge across launches when every aggregation merges
            # field-wise and any ORDER BY-aware trim is expressible on the
            # device (kernel_order_spec); otherwise the host merge remains
            # (sketches' vector and coupled fields, as in the JAX package)
            merge_ok = all(fn.field_kinds is not None and not fn.pairwise_merge for fn in aggs)
            morder = None
            if merge_ok and planner.order_by_agg_index(ctx) is not None:
                if order_spec is None:
                    merge_ok = False  # the host ranks by fn.final
                else:
                    morder = order_spec  # (agg index, order FIELD name, asc)
            if merge_ok:
                field_ops = [{f: FIELD_COMBINE[f] for f in fn.field_kinds} for fn in aggs]

                def _merge(uniq_list, parts_list):
                    uniq = torch.cat([u.reshape(-1) for u in uniq_list])
                    parts = [
                        {f: torch.cat([p[i][f].reshape(-1) for p in parts_list]) for f in field_ops[i]}
                        for i in range(len(field_ops))
                    ]
                    return merge_sparse_tables(uniq, parts, num_slots, field_ops, order_spec=morder)

                sparse_merge_fn = cached.sparse_merge_fn if cached is not None else _merge

        # launch-schedule params: batch doc offset and fresh floor, always
        # present so every launch shares one params structure; they stay
        # host ints at launch (the closure branches on them, eagerly)
        fc.params["__boff__"] = np.int32(0)
        fc.params["__fresh__"] = np.int32(0)
        # index-resolved filter columns never ship to the device, and a
        # selection's launches read only the filter's columns
        keep = fc.used_columns if kind == "selection" else planner._non_filter_columns(ctx, view) | fc.used_columns
        return _DistPlan(
            position_docs=L * D_full,
            kind=kind,
            fn=cached.fn if cached is not None else kernel,
            params=fc.params,
            needed_columns=[c for c in needed if c in keep],
            aggs=aggs,
            group_dims=group_dims,
            num_groups=num_groups,
            row_sharded_params=frozenset(fc.row_sharded_params),
            index_uses=tuple(fc.index_uses),
            batch_docs=batch_docs,
            batch_offsets=tuple(batch_offsets),
            sparse_merge_fn=sparse_merge_fn,
            word_fused=word_fused,
            select_columns=tuple(select_columns),
        )

    # ------------------------------------------------------------------
    def batch_params(self, plan: _DistPlan, off: int, fresh: int, pos: int = 0) -> Dict[str, Any]:
        """Host params of mesh position `pos`'s launch covering docs [off,
        off + batch_docs) of its shards: schedule scalars set (`__boff__` is
        the launch's global doc base), row-sharded bitmap words cut to the
        position's row and sliced on the doc axis."""
        p = dict(plan.params)
        p["__boff__"] = np.int32(pos * plan.position_docs + off)
        p["__fresh__"] = np.int32(fresh)
        wlo, whi = off // 32, (off + plan.batch_docs) // 32
        for k in plan.row_sharded_params:
            w = plan.params[k]  # [ndev, L, D // 32]
            p[k] = np.ascontiguousarray(w[pos: pos + 1, :, wlo:whi]).reshape(1, -1)
        return p

    def _shared_params(self, plan: _DistPlan) -> Dict[str, Dict[str, torch.Tensor]]:
        """Batch-invariant params, on each device of the mesh once per
        query, keyed by str(device)."""
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for dev in self.positions:
            if str(dev) not in out:
                out[str(dev)] = {
                    k: executor._param_tensor(v, dev)
                    for k, v in plan.params.items()
                    if k not in plan.row_sharded_params and k not in _SCHEDULE_PARAMS
                }
        return out

    def _copier(self, dev: torch.device):
        """The tiered path's host-to-device copy: on CUDA through the
        card's copy stream (parallel/staging.py), on the CPU None (the
        table's plain copy)."""
        if dev.type != "cuda":
            return None
        cs = self._copy_streams.get(str(dev))
        if cs is None:
            from pinot_tpu_torch.parallel.staging import CopyStream

            cs = self._copy_streams[str(dev)] = CopyStream(dev, self.launch_bytes)
        return cs.copy

    def _stage_batch(self, plan: _DistPlan, stacked, j: int, shared, prefetch: bool = False):
        """Macro-batch j's device inputs, one (cols, params, ready) a mesh
        position: position p's doc slice of its shards comes from the
        table's cache; with residency it rides the budgeted cache and, on
        CUDA, the card's copy stream, and `ready` is the event after its
        copies (None otherwise).  Runs on the residency staging thread when
        the pipeline prefetches."""
        off, fresh = plan.batch_offsets[j]
        L = stacked.num_shards // self.num_devices
        out = []
        for p, (dev, pid) in enumerate(zip(self.positions, self.mesh.position_ids)):
            copy = self._copier(dev) if self.residency is not None else None
            cols, _ = stacked.to_device(
                dev, plan.needed_columns, doc_slice=(off, off + plan.batch_docs),
                with_valid=False, packed_codes=True, residency=self.residency, prefetch=prefetch, copy=copy,
                shards=(p * L, (p + 1) * L), position=pid,
            )
            on_dev = shared.get(str(dev), {})
            params = dict(on_dev)
            for k, v in self.batch_params(plan, off, fresh, p).items():
                if k in _SCHEDULE_PARAMS:
                    params[k] = int(v)
                elif k in on_dev:
                    continue
                elif copy is not None:
                    params[k] = copy(np.ascontiguousarray(executor.param_array(v)))
                else:
                    params[k] = executor._param_tensor(v, dev)
            ready = self._copy_streams[str(dev)].record() if copy is not None else None
            out.append((cols, params, ready))
        return out

    @staticmethod
    def _await_staged(cols, params, ready, dev: torch.device):
        """A staged position made usable on its device's compute stream: it
        waits on the batch's copy event, and the copied tensors are marked
        in use there."""
        if ready is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(ready)
            # the caching allocator must not hand a block of a slice
            # evicted mid-scan to the next copy before this scan is done
            for entry in cols.values():
                for t in entry.values():
                    t.record_stream(compute)
            for t in params.values():
                if isinstance(t, torch.Tensor):
                    t.record_stream(compute)
        return cols, params

    @staticmethod
    def _combine_partials(aggs, parts_list):
        """Fold per-launch partials (a list over launches of per-agg field
        dicts) on their device: the add / min / max of the field names, or
        the function's pairwise merge for coupled fields."""
        out = parts_list[0]
        for nxt in parts_list[1:]:
            out = [
                fn.merge(p, q) if fn.pairwise_merge else {f: combine_field(f, p[f], q[f]) for f in p}
                for fn, p, q in zip(aggs, out, nxt)
            ]
        return out

    def _fold_launch(self, plan: _DistPlan, outs: List[Any]) -> Any:
        """One launch's per-position outputs as the launch's output: scalar
        and dense tables fold across positions on the home device (the JAX
        engine's in-graph psum: parallel/mesh.fold_partials), sparse tables
        and selection masks stay a list in position order."""
        if plan.kind not in ("aggregation", "groupby_dense"):
            return outs
        if len(outs) == 1:
            return outs[0]
        shape = self.mesh.shape
        if plan.kind == "aggregation":
            return mesh_mod.fold_partials(plan.aggs, outs, shape)
        presence = mesh_mod.psum_hierarchical([p for p, _ in outs], shape)
        return presence, mesh_mod.fold_partials(plan.aggs, [q for _, q in outs], shape)

    def _completion(self):
        """Markers of the work queued so far on each card of the mesh, or
        None on the CPU."""
        cards = {str(d): d for d in self.positions if d.type == "cuda"}
        if not cards:
            return None
        events = []
        for dev in cards.values():
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return events

    @staticmethod
    def _drain(pending) -> Any:
        """Completion fence for one in-flight launch: waits for that launch's
        own completion events (not the whole stream); its outputs stay on the
        device for the combine."""
        out, events = pending
        for ev in events or ():
            # one launch's own events: later launches stay in flight
            ev.synchronize()  # pinot-lint: disable=W002
        return out

    def _run(self, ctx, plan: _DistPlan, stacked, stats: ExecutionStats, trace: Optional[Trace] = None):
        depth = max(1, int(self.pipeline_depth))
        # graceful degradation: under process-wide memory pressure
        # (cluster/admission.py) the pipeline sheds in-flight launches, one
        # fewer per pressure level past 1, down to a serialised loop
        pressure = current_pressure_level()
        if pressure:
            depth = pipeline_depth_under_pressure(depth, pressure)
            if trace is not None:
                trace.annotate(pressure=pressure)
        n_batches = len(plan.batch_offsets)
        shared = self._shared_params(plan)
        # Staging pipeline.  With residency, batch j+1's copies run on the
        # residency manager's staging thread while batch j scans (on CUDA
        # on the card's copy stream; the launch waits on the batch's copy
        # event).  The single staging worker keeps stages FIFO, so consuming
        # j never waits behind a stage issued for j+1.  Without residency
        # every batch stages before the first launch: a pageable copy on
        # the compute stream would wait behind the queued launches.
        use_stream = self.residency is not None and n_batches > 1
        staged: Dict[int, Any] = {}
        if self.residency is None:
            staged.update((j, self._stage_batch(plan, stacked, j, shared)) for j in range(n_batches))

        def _ensure(j: int, prefetch: bool) -> None:
            if j >= n_batches or j in staged:
                return
            if use_stream:
                staged[j] = self.residency.submit(self._stage_batch, plan, stacked, j, shared, prefetch)
            else:
                staged[j] = self._stage_batch(plan, stacked, j, shared)

        def _consume(j: int):
            item = staged.pop(j)
            if use_stream:
                if item.done():
                    METRICS.counter("engine.prefetchHits").inc()
                    item = item.result()
                else:
                    # the staging stream is behind the launches: timed stall
                    tw0 = time.perf_counter()
                    item = item.result()
                    METRICS.counter("engine.stagingStalls").inc()
                    METRICS.histogram("residency.stagingStallMs").update((time.perf_counter() - tw0) * 1000.0)
            return [self._await_staged(*pos_item, dev) for pos_item, dev in zip(item, self.positions)]

        batch_outs: List[Any] = []
        pending: List[Any] = []
        tl0 = time.perf_counter()
        try:
            _ensure(0, False)
            for i in range(n_batches):
                for j in range(i + 1, min(i + 1 + depth, n_batches)):
                    _ensure(j, True)
                # one launch a position (in turns where positions share a
                # device), then the positions' fold
                outs = [plan.fn(cols, params, dev) for (cols, params), dev in zip(_consume(i), self.positions)]
                pending.append((self._fold_launch(plan, outs), self._completion()))
                if len(pending) >= depth:
                    batch_outs.append(self._drain(pending.pop(0)))
            while pending:
                batch_outs.append(self._drain(pending.pop(0)))
        except BaseException:
            # a failed stage (re-raised by its future) or launch: no stage of
            # this query runs on after it; the failed stage has unwound its
            # charge (abort_stage)
            futures = [f for f in staged.values() if isinstance(f, concurrent.futures.Future)]
            for f in futures:
                f.cancel()
            concurrent.futures.wait(futures)
            raise
        stats.device_ms += (time.perf_counter() - tl0) * 1000.0
        stats.kernel_bytes += n_batches * stacked.num_shards * plan.batch_docs * perf.analytic_bytes_per_row(
            (stacked.column(n) for n in plan.needed_columns), bitmap_params=len(plan.row_sharded_params)
        )

        if plan.kind == "aggregation":
            host = executor._to_host(self._combine_partials(plan.aggs, batch_outs))
            return AggSegmentResult(partials=[fn.host_partial(p) for fn, p in zip(plan.aggs, host)])

        if plan.kind == "selection":
            # each launch's masks -> global flat doc ids on the device (the
            # kernel masked padding and a tail window's re-covered columns);
            # one sorted id vector comes home
            D, Db = stacked.docs_per_shard, plan.batch_docs
            L = stacked.num_shards // self.num_devices
            ids = []
            for (off, _fresh), masks in zip(plan.batch_offsets, batch_outs):
                for p, m in enumerate(masks):
                    local = torch.nonzero(m).reshape(-1)
                    ids.append(((p * L + local // Db) * D + off + local % Db).to(self.device))
            docids = torch.sort(torch.cat(ids)).values.cpu().numpy()
            stats.bytes_to_host += int(docids.nbytes)
            return self._gather_selection(ctx, plan, stacked, docids)

        if plan.kind == "groupby_dense":
            presence = batch_outs[0][0]
            for p, _ in batch_outs[1:]:
                presence = presence + p
            presence, partials = executor._to_host((presence, self._combine_partials(plan.aggs, [p for _, p in batch_outs])))
            shim = SimpleNamespace(group_dims=plan.group_dims, aggs=plan.aggs)
            dense = DenseGroupData(
                presence=presence, partials=partials, key_space=executor._key_space_id(shim),
                group_dims=plan.group_dims,
            )
            keys, sliced = executor._dense_to_present(
                shim, presence, partials, ctx.num_groups_limit,
                order_trim=planner.order_by_agg_index(ctx),
            )
            stats.num_groups = len(keys[0]) if keys else 0
            return GroupBySegmentResult(keys=keys, partials=sliced, dense=dense)

        # groupby_sparse: every launch's tables, position by position, in
        # order (the JAX engine's [B * ndev * K] stack)
        batch_outs = [out for outs in batch_outs for out in outs]
        if plan.sparse_merge_fn is not None:
            # device merge: only the final [num_slots] tables come home
            batch_outs = mesh_mod.to_home(batch_outs, self.device)
            uniq, partials = executor._to_host(
                plan.sparse_merge_fn([u for u, _ in batch_outs], [p for _, p in batch_outs])
            )
            res = executor.sparse_tables_to_result(
                plan.group_dims, plan.aggs, uniq, partials, ctx.num_groups_limit,
                order_trim=None, assume_unique=True,
            )
        else:
            # host merge: launches concatenate and duplicate keys fold
            host = executor._to_host(batch_outs)
            uniq = np.concatenate([u.reshape(-1) for u, _ in host])
            partials = [
                {f: np.concatenate([p[i][f] for _, p in host]) for f in host[0][1][i]}
                for i in range(len(host[0][1]))
            ]
            res = executor.sparse_tables_to_result(
                plan.group_dims, plan.aggs, uniq, partials, ctx.num_groups_limit,
                order_trim=planner.order_by_agg_index(ctx),
            )
        stats.num_groups = len(res.keys[0]) if res.keys else 0
        return res

    @staticmethod
    def _gather_selection(ctx, plan: _DistPlan, stacked, docids: np.ndarray) -> SelectionSegmentResult:
        """Rows of the matched global doc ids (ascending): the ORDER BY
        top-k on the shared dictionary's codes (global sort ranks), then the
        decoded select and order columns."""
        want = ctx.offset + ctx.limit
        if ctx.order_by:
            if len(docids) > want:
                lex_keys: List[np.ndarray] = []
                for ob in reversed(ctx.order_by):
                    c = stacked.column(ob.expr.op)
                    key, null_rank = executor.order_key_arrays(
                        c.codes.reshape(-1) if c.codes is not None else None,
                        c.values.reshape(-1) if c.values is not None else None,
                        c.nulls.reshape(-1) if c.nulls is not None else None,
                        docids, ob.ascending, ob.nulls_last,
                    )
                    lex_keys.append(key)
                    if null_rank is not None:
                        lex_keys.append(null_rank)
                docids = docids[np.lexsort(tuple(lex_keys))[:want]]
        else:
            docids = docids[:want]

        def _decoded(name: str) -> np.ndarray:
            c = stacked.column(name)
            vals = stacked.decoded_rows(name, docids)
            if c.nulls is not None and ctx.null_handling:
                vals = np.asarray(vals, dtype=object)
                vals[c.nulls.reshape(-1)[docids]] = None
            return vals

        arrays: Dict[str, np.ndarray] = {name: _decoded(name) for name in plan.select_columns}
        for i, ob in enumerate(ctx.order_by):
            arrays[f"__ord{i}"] = _decoded(ob.expr.op)
        cols_out = list(plan.select_columns) + [f"__ord{i}" for i in range(len(ctx.order_by))]
        return SelectionSegmentResult(columns=cols_out, arrays=arrays)


class ReplicatedEngine:
    """QPS deployment of a 2-D mesh: one 1-D DistributedEngine a replica
    row, each holding a FULL copy of every registered table on its own
    positions (replica-group serving).

    Routing, as in the JAX package: whole same-shape batches go to one
    replica row and rows rotate round-robin, so concurrent load spreads
    across rows while each row's plan and device caches stay hot.  With a
    coordinator attached, `mesh_placement(R)` maps replica groups onto mesh
    rows, and a row whose replica group has no live server leaves the
    rotation until it recovers.  Each row gets its OWN residency manager
    with an even share of the device cache budget
    (segment/residency.row_residency), so one row's working set never
    evicts another's, and its own lock: a row runs one query at a time.

    mesh: a 2-D mesh (parallel/mesh.make_mesh2d); None is
    make_mesh2d(num_replicas, device=device)."""

    def __init__(
        self,
        mesh: Optional[mesh_mod.Mesh] = None,
        num_replicas: int = 2,
        hbm_cache_bytes: Optional[int] = None,
        coordinator=None,
        device: DeviceLike = None,
        **engine_kwargs,
    ):
        import threading

        from pinot_tpu_torch.segment.residency import row_residency

        if mesh is None:
            mesh = mesh_mod.make_mesh2d(num_replicas, device=device)
        self.mesh = mesh
        rows = mesh_mod.replica_rows(mesh)
        self.engines: List[DistributedEngine] = []
        for r, row_mesh in enumerate(rows):
            res = row_residency(len(rows), r, total_bytes=hbm_cache_bytes)
            self.engines.append(DistributedEngine(
                mesh=row_mesh, residency=res, hbm_cache_bytes=0 if res is None else None, **engine_kwargs))
        self.coordinator = coordinator
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._row_locks = [threading.Lock() for _ in self.engines]

    @property
    def num_replicas(self) -> int:
        return len(self.engines)

    def register_table(self, name: str, stacked) -> None:
        for eng in self.engines:
            eng.register_table(name, stacked)

    def _live_rows(self) -> List[int]:
        """Rows eligible for routing: all of them standalone; with a
        coordinator, the rows whose replica group still has a live server
        (every row when none has)."""
        all_rows = list(range(len(self.engines)))
        if self.coordinator is None:
            return all_rows
        placement = self.coordinator.mesh_placement(len(self.engines))
        live = [r for r in all_rows if placement.get(r)]
        return live or all_rows

    def _next_row(self) -> int:
        rows = self._live_rows()
        with self._rr_lock:
            self._rr += 1
            return rows[self._rr % len(rows)]

    def query(self, sql: str) -> ResultTable:
        row = self._next_row()
        with self._row_locks[row]:
            return self.engines[row].query(sql)

    def execute(self, ctx: QueryContext) -> ResultTable:
        row = self._next_row()
        with self._row_locks[row]:
            return self.engines[row].execute(ctx)

    def execute_many(self, ctxs: List[QueryContext]) -> List[ResultTable]:
        """Batch routing: members group by shape fingerprint and every
        group lands WHOLE on one replica row (a member-axis launch never
        splits across rows), rows rotating a group."""
        results: List[Optional[ResultTable]] = [None] * len(ctxs)
        groups: Dict[Any, List[int]] = {}
        for i, ctx in enumerate(ctxs):
            stacked = self.engines[0].tables.get(ctx.table)
            if ctx.joins or ctx.set_ops or stacked is None:
                results[i] = self.execute(ctx)
                continue
            key = (ctx.table, shape_digest(ctx.shape_fingerprint(column_info_from(stacked))))
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            row = self._next_row()
            with self._row_locks[row]:
                outs = self.engines[row].execute_many([ctxs[i] for i in idxs])
            for i, out in zip(idxs, outs):
                results[i] = out
        return results

    def shutdown(self) -> None:
        """Stop every row's residency staging thread."""
        for eng in self.engines:
            if eng.residency is not None:
                eng.residency.shutdown()
