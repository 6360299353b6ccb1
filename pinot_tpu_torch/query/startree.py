"""Star-tree query routing and execution over collapsed level tables.

Port of pinot_tpu/query/startree.py.  Reference parity: Pinot injects the
star-tree when a group-by's filter and group columns fall inside the tree's
dimension split order and every aggregation has a matching function-column
pair (AggregationPlanNode, StarTreeFilterOperator, the StarTree
aggregation/group-by executors).

Tree traversal is level selection (indexes/startree.py): ``pick_tree``
takes the smallest prefix level covering the query's dimensions, and
``execute_star`` compiles the ordinary FilterCompiler against the level's
facade (the parent's dictionaries, so the result merges with raw-scan
segments in one key space) and combines the pre-aggregated partial FIELDS
per group.  Rows scanned = the level's rows.

Where the JAX package finishes on the host with numpy, the port runs on the
segment's device: the level's tables (its dictionaries' values included)
are an entry of the segment's device cache (``segment.star_entry``), staged
once and released or evicted with the segment's columns, and the filter mask, the packed group key, the ``unique`` and the field
combines (``index_add_`` / ``scatter_reduce_``) run beside the segment's
columns; only the [groups] tables come home.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.indexes.startree import scatter_combine
from pinot_tpu_torch.query import planner
from pinot_tpu_torch.query.executor import _param_tensor
from pinot_tpu_torch.query.filter import FilterCompiler
from pinot_tpu_torch.query.functions import for_spec
from pinot_tpu_torch.query.ir import QueryContext
from pinot_tpu_torch.query.result import AggSegmentResult, ExecutionStats, GroupBySegmentResult
from pinot_tpu_torch.segment.segment import star_entry


def pick_tree(ctx: QueryContext, segment) -> Optional[Tuple[str, int]]:
    """(tree name, level k) when a tree of this segment can answer ctx."""
    trees = segment.indexes.get("startree", {})
    if not trees or ctx.joins or not ctx.is_aggregate:
        return None
    for g in ctx.group_by:
        if not g.is_column or g.op == "*":
            return None
    group_cols = {g.op for g in ctx.group_by}
    filter_cols = set(ctx.filter.columns()) if ctx.filter else set()
    agg_filter_cols = set()
    for spec in ctx.aggregations:
        if spec.expr is not None and not spec.expr.is_column:
            return None
        if spec.filter is not None:
            agg_filter_cols |= set(spec.filter.columns())
    dims_used = group_cols | filter_cols | agg_filter_cols
    if "*" in dims_used:
        return None

    best: Optional[Tuple[str, int]] = None
    for name, st in trees.items():
        k = st.level_for(dims_used)
        if k is None:
            continue
        ok = True
        for spec in ctx.aggregations:
            col = spec.expr.op if spec.expr is not None else "*"
            if col != "*" and segment.column(col).nulls is not None:
                ok = False  # star count fields assume null-free metrics
                break
            if not st.has_fields(spec.function, col):
                ok = False
                break
        if not ok:
            continue
        if best is None or st.levels[k].num_rows < trees[best[0]].levels[best[1]].num_rows:
            best = (name, k)
    return best


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def execute_star(ctx: QueryContext, segment, tree: str, k: int, device: torch.device):
    """Run ctx against level k of the segment's star-tree `tree` on
    `device`; (SegmentResult, ExecutionStats), or None when a runtime limit
    (a composite key past 63 bits) sends the query to the scan path after
    all."""
    st = segment.indexes["startree"][tree]
    lvl = st.levels[k]
    view = lvl.facade(segment)
    stats = ExecutionStats(
        num_segments_queried=1,
        num_segments_processed=1,
        num_docs_scanned=lvl.num_rows,
        total_docs=segment.num_docs,
    )

    fc = FilterCompiler(view, null_handling=False)
    filter_fn = fc.compile(ctx.filter)
    agg_specs = list(ctx.aggregations)
    agg_filter_fns = [fc.compile(s.filter) if s.filter is not None else None for s in agg_specs]

    entry_name = star_entry(tree, k)
    tables = segment.to_device(device, columns=[entry_name])[entry_name]
    cols: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, c in view.columns.items():
        entry: Dict[str, torch.Tensor] = {}
        if c.codes is not None:
            entry["codes"] = tables[name]
            if (name, "dict") in tables:
                entry["dict"] = tables[(name, "dict")]
        if c.values is not None:
            entry["values"] = tables[name].to(getattr(torch, str(c.values.dtype)))
        cols[name] = entry
    params = {key: _param_tensor(v, device) for key, v in fc.params.items()}
    tmask = filter_fn(cols, params, device)[0]
    agg_masks = [tmask if fn is None else (tmask & fn(cols, params, device)[0]) for fn in agg_filter_fns]

    counts = tables[("*", "count")]
    aggs = [for_spec(s) for s in agg_specs]
    stats.add_index_uses(fc.index_uses)
    stats.add_index_uses([("/".join(st.split_order[:k]) or "*", "startree")])

    def field_source(spec, kind) -> torch.Tensor:
        if kind == "count":
            return counts
        return tables[(spec.expr.op, kind)]

    if not ctx.group_by:
        partials: List[Dict[str, np.ndarray]] = []
        for spec, fn, m in zip(agg_specs, aggs, agg_masks):
            p: Dict[str, np.ndarray] = {}
            for fname, kind in fn.field_kinds.items():
                src = field_source(spec, kind)
                if kind in ("count", "sum", "sumsq"):
                    v = torch.where(m, src, torch.zeros((), dtype=src.dtype, device=device)).sum()
                else:
                    ident = float("inf") if kind == "min" else float("-inf")
                    v = torch.where(m, src.to(torch.float64), torch.full((), ident, dtype=torch.float64, device=device))
                    v = (v.min() if kind == "min" else v.max()) if v.numel() else torch.tensor(ident, dtype=torch.float64)
                p[fname] = _host(v)
            partials.append(p)
        return AggSegmentResult(partials=partials), stats

    # group-by: the level's dim codes packed into composite keys (the
    # raw-scan packing, so decoded keys land in the same key space)
    group_dims = [planner._group_dim(g, view, False) for g in ctx.group_by]
    packed = torch.zeros(lvl.num_rows, dtype=torch.int64, device=device)
    scale = 1
    for gd in reversed(group_dims):
        if scale > (1 << 62) // max(1, gd.cardinality):
            return None  # >63-bit composite key: the scan path takes it
        code = tables[gd.name] if gd.kind == "dict" else tables[gd.name] - gd.base
        packed += code * scale
        scale *= gd.cardinality

    sel = torch.nonzero(tmask).reshape(-1)
    uniq, inverse_sel = torch.unique(packed[sel], sorted=True, return_inverse=True)
    if len(uniq) > ctx.num_groups_limit:
        keep = inverse_sel < ctx.num_groups_limit
        sel = sel[keep]
        inverse_sel = inverse_sel[keep]
        uniq = uniq[: ctx.num_groups_limit]
    n_groups = int(uniq.shape[0])
    keys = planner.decode_packed_keys(group_dims, _host(uniq))

    partials = []
    for spec, fn, m in zip(agg_specs, aggs, agg_masks):
        msel = m[sel]
        p = {}
        for fname, kind in fn.field_kinds.items():
            src = field_source(spec, kind)[sel]
            p[fname] = _host(scatter_combine(kind, inverse_sel[msel], src[msel], n_groups))
        partials.append(p)
    stats.num_groups = n_groups
    return GroupBySegmentResult(keys=keys, partials=partials, dense=None), stats


def try_startree(ctx: QueryContext, segment, device: torch.device):
    """The executor's hook: (result, stats) when a star-tree served the
    query on `device`, else None.  `SET useStarTree=false` turns it off."""
    opt = ctx.options.get("useStarTree", True)
    if (not opt) or (isinstance(opt, str) and opt.lower() in ("false", "0")):
        return None
    # upsert segments: pre-aggregated levels cannot honour per-row
    # validDocIds (the reference likewise excludes star-trees from upsert
    # tables)
    if getattr(segment, "valid_docs", None) is not None:
        return None
    pick = pick_tree(ctx, segment)
    if pick is None:
        return None
    return execute_star(ctx, segment, pick[0], pick[1], device)
