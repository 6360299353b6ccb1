"""Segment execution: prune -> plan -> launch -> segment result.

Port of pinot_tpu/query/executor.py for the single-table slice.  Reference
parity: ServerQueryExecutorV1Impl.executeInternal — server-side pruning from
metadata, then per-segment plan execution.

``launch_segment`` plans, ships the needed columns and the params to the
device and runs the planned closure; on CUDA its work is queued on the
current stream and the call returns before the device finishes.
``collect_segment`` moves the outputs to the host (``.cpu()``, which waits
for the device) and decodes them: dense group table -> present keys.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.query import planner
from pinot_tpu_torch.query.ir import FilterNode, FilterOp, PredicateType, QueryContext
from pinot_tpu_torch.query.result import (
    AggSegmentResult,
    DenseGroupData,
    ExecutionStats,
    GroupBySegmentResult,
)
from pinot_tpu_torch.segment.segment import ImmutableSegment


# ---------------------------------------------------------------------------
# Pruning (SegmentPrunerService analog — host-side, metadata only)
# ---------------------------------------------------------------------------
def _top_level_predicates(node: Optional[FilterNode]):
    if node is None:
        return []
    if node.op is FilterOp.PRED:
        return [node.predicate]
    if node.op is FilterOp.AND:
        out = []
        for c in node.children:
            out.extend(_top_level_predicates(c))
        return out
    return []


def prune_segment(ctx: QueryContext, segment: ImmutableSegment) -> bool:
    """True if the segment provably matches no rows (value pruner)."""
    for p in _top_level_predicates(ctx.filter):
        if not p.lhs.is_column or p.lhs.op == "*" or p.lhs.op not in segment.columns:
            continue
        c = segment.column(p.lhs.op)
        s = c.stats
        if s.num_docs == 0:
            return True
        if p.ptype is PredicateType.EQ:
            v = p.values[0]
            if c.has_dictionary:
                if c.dictionary.index_of(v) < 0:
                    return True
            elif s.min_value is not None and not c.data_type.is_string_like:
                try:
                    if v < s.min_value or v > s.max_value:
                        return True
                except TypeError:
                    pass
        elif p.ptype is PredicateType.IN:
            if c.has_dictionary and all(c.dictionary.index_of(v) < 0 for v in p.values):
                return True
        elif p.ptype is PredicateType.RANGE and s.min_value is not None:
            try:
                if p.lower is not None and (
                    s.max_value < p.lower or (s.max_value == p.lower and not p.lower_inclusive)
                ):
                    return True
                if p.upper is not None and (
                    s.min_value > p.upper or (s.min_value == p.upper and not p.upper_inclusive)
                ):
                    return True
            except TypeError:
                pass
    return False


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------
def _param_tensor(v, device: torch.device) -> torch.Tensor:
    """Host param (numpy array or scalar) -> tensor on `device`; uint32
    bitmap words travel as their int32 view."""
    a = np.asarray(v)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def launch_segment(ctx: QueryContext, segment: ImmutableSegment, device: torch.device):
    """Plan, ship inputs and run the segment's planned closure.  Returns the
    pending state collect_segment finishes."""
    stats = ExecutionStats(
        num_segments_queried=1,
        num_segments_processed=1,
        num_docs_scanned=segment.num_docs,
        total_docs=segment.num_docs,
    )
    plan = planner.plan_segment(ctx, segment, device)
    stats.filter_index_uses = tuple(plan.index_uses)
    cols = segment.to_device(device, columns=plan.needed_columns, packed_codes=True)
    params = {k: _param_tensor(v, device) for k, v in plan.params.items()}
    out = plan.fn(cols, params, device)
    return ctx, segment, plan, out, stats


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def collect_segment(state):
    """Move the outputs to the host and decode them."""
    ctx, segment, plan, out, stats = state
    host = _to_host(out)
    if plan.kind == "aggregation":
        return AggSegmentResult(partials=list(host)), stats
    presence, partials = host
    dense = DenseGroupData(
        presence=presence,
        partials=partials,
        key_space=_key_space_id(plan),
        group_dims=plan.group_dims,
    )
    keys, sliced = _dense_to_present(
        plan, presence, partials, ctx.num_groups_limit,
        order_trim=planner.order_by_agg_index(ctx),
    )
    stats.num_groups = len(keys[0]) if keys else 0
    return GroupBySegmentResult(keys=keys, partials=sliced, dense=dense), stats


def _key_space_id(plan) -> Tuple:
    parts = []
    for gd in plan.group_dims:
        if gd.kind == "dict":
            parts.append(("dict", gd.name, gd.dictionary.fingerprint(), gd.null_code))
        else:
            parts.append(("rawint", gd.name, gd.base, gd.cardinality))
    return tuple(parts)


def _order_trim_select(aggs, partials_for, candidates_key, order_trim, limit):
    """Indices (into the candidate set) surviving an ORDER BY-aware trim:
    rank by the order aggregation's FINAL value (NaN last), tie-break by
    packed key — the TableResizer comparator analog."""
    idx, asc = order_trim
    vals = np.asarray(aggs[idx].final(partials_for(idx)))
    k = vals.astype(np.float64)
    if not asc:
        k = -k
    k = np.where(np.isnan(k), np.inf, k)
    sel = np.lexsort((candidates_key, k))[:limit]
    sel.sort()
    return sel


def _dense_to_present(
    plan, presence: np.ndarray, partials, num_groups_limit: Optional[int] = None,
    order_trim: Optional[Tuple[int, bool]] = None,
) -> Tuple[List[np.ndarray], List[Dict]]:
    """Dense table -> (decoded keys, partials) for present groups only.

    num_groups_limit caps TRACKED groups (the numGroupsLimit safety valve);
    with an ORDER BY over an aggregate the trim ranks groups by it,
    otherwise lowest packed keys win (deterministic)."""
    present = np.nonzero(presence > 0)[0]
    if num_groups_limit is not None and len(present) > num_groups_limit:
        sel = None
        if order_trim is not None:
            sel = _order_trim_select(
                plan.aggs,
                lambda i: {f: np.asarray(a)[present] for f, a in partials[i].items()},
                present,
                order_trim,
                num_groups_limit,
            )
        present = present[sel] if sel is not None else present[:num_groups_limit]
    keys = planner.decode_packed_keys(plan.group_dims, present)
    sliced = [{f: np.asarray(arr)[present] for f, arr in p.items()} for p in partials]
    return keys, sliced
