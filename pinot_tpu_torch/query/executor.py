"""Segment execution: prune -> plan -> launch -> segment result.

Port of pinot_tpu/query/executor.py for the single-table slice.  Reference
parity: ServerQueryExecutorV1Impl.executeInternal — server-side pruning from
metadata, then per-segment plan execution.

``launch_segment`` plans, ships the needed columns and the params to the
device and runs the planned closure; on CUDA its work is queued on the
current stream and the call returns before the device finishes.
``collect_segment`` moves the outputs to the host (``.cpu()``, which waits
for the device) and decodes them: dense group table -> present keys, sparse
fixed-slot tables -> merged keys (``sparse_tables_to_result``, which the
distributed engine shares).  A selection's row mask turns into matched doc
ids on the device (``torch.nonzero``), and only the ids come home; the host
then trims them per segment (ORDER BY over dictionary codes, which are sort
ranks within the segment) and gathers the decoded rows; UNNEST(mvcol)
repeats each gathered row once per element.  A segment whose star-tree
covers the query answers from the tree's level instead
(query/startree.py).

Cross-query batching (``launch_segment_batch`` / ``collect_segment_batch``):
N same-shape queries over one segment run as ONE call of
``torch.func.vmap`` over the shared planned closure, the members' literal
params stacked on a leading member axis and the segment's columns shared;
the fused scan's vmap rule (ops/fused_scan.py) makes that one member-axis
kernel launch.  The JAX package pads a batch to ``batch_width()`` lanes so
one compiled program serves every size; eager torch compiles nothing, so
the port launches exactly the n live members.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.query import planner
from pinot_tpu_torch.query.functions import combine_field
from pinot_tpu_torch.query.ir import Expr, FilterNode, FilterOp, PredicateType, QueryContext, WindowSpec
from pinot_tpu_torch.query.result import (
    AggSegmentResult,
    DenseGroupData,
    ExecutionStats,
    GroupBySegmentResult,
    SelectionSegmentResult,
)
from pinot_tpu_torch.query.transform import eval_expr_host
from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.utils import perf


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
    """True if the segment provably matches no rows (value/bloom pruner)."""
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
            bloom = segment.indexes.get("bloom", {}).get(p.lhs.op)
            if bloom is not None and not bloom.might_contain(v):
                return True
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
def param_array(v) -> np.ndarray:
    """Host param (numpy array or scalar) as the array its tensor is made
    from: uint32 bitmap words as their int32 view."""
    a = np.asarray(v)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _param_tensor(v, device: torch.device) -> torch.Tensor:
    """Host param -> tensor on `device` (a copy on the current stream)."""
    return torch.from_numpy(np.ascontiguousarray(param_array(v))).to(device)


def launch_segment(ctx: QueryContext, segment: ImmutableSegment, device: torch.device, residency=None):
    """Plan, ship inputs and run the segment's planned closure.  Returns the
    pending state collect_segment finishes.  A query a star-tree of the
    segment answers runs over the tree's level instead (query/startree.py).
    residency: the server's device cache the columns page through (None:
    the segment's own pinned cache)."""
    from pinot_tpu_torch.query.startree import try_startree

    star = try_startree(ctx, segment, device)
    if star is not None:
        return ("star", star)
    stats = ExecutionStats(
        num_segments_queried=1,
        num_segments_processed=1,
        num_docs_scanned=segment.num_docs,
        total_docs=segment.num_docs,
    )
    plan = planner.plan_segment(ctx, segment, device)
    stats.filter_index_uses = tuple(plan.index_uses)
    cost = perf.analytic_cost(
        segment.num_docs,
        perf.analytic_bytes_per_row(segment.column(n) for n in plan.needed_columns),
        kind=plan.kind,
        num_groups=plan.num_groups,
        num_entries=len(plan.aggs),
    )
    stats.kernel_bytes = cost.bytes_accessed
    stats.kernel_flops = cost.flops
    stats.kernel_cost_source = cost.source
    cols = segment.to_device(device, columns=plan.needed_columns, packed_codes=True, residency=residency)
    params = {k: _param_tensor(v, device) for k, v in plan.params.items()}
    out = plan.fn(cols, params, device)
    return ctx, segment, plan, out, stats


def launch_stats(state) -> Optional[ExecutionStats]:
    """The stats of an unbatched launch state (None for a star-tree answer)."""
    return None if state[0] == "star" else state[4]


def pending_outputs(states) -> list:
    """Device outputs of the not-yet-collected launch states (a star-tree
    answer has none): what the trace fence waits for, once over all of
    them, never per launch (a fence in the launch loop would serialise the
    pipeline)."""
    return [st[4] if st[0] == "batch" else st[3] for st in states if st[0] != "star"]


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def matched_docids(tmask: torch.Tensor) -> np.ndarray:
    """Ascending doc ids where the row mask is set: found on the mask's
    device, so only the ids cross to the host."""
    return torch.nonzero(tmask.reshape(-1)).reshape(-1).cpu().numpy()


def collect_segment(state):
    """Move the outputs to the host and decode them."""
    if state[0] == "star":
        return state[1]
    ctx, segment, plan, out, stats = state
    if plan.kind == "selection":
        docids = matched_docids(out)
        stats.bytes_to_host = int(docids.nbytes)
        return _gather_selection(ctx, plan, segment, docids), stats
    return _decode_host(ctx, segment, plan, _to_host(out), stats)


def _decode_host(ctx, segment, plan, host, stats):
    """Host decode of one query's (already fetched) outputs, shared by the
    unbatched collect and each member of a batched one."""
    if plan.kind == "aggregation":
        return AggSegmentResult(partials=[fn.host_partial(p) for fn, p in zip(plan.aggs, host)]), stats
    if plan.kind == "groupby_sparse":
        uniq, partials = host
        res = sparse_tables_to_result(
            plan.group_dims, plan.aggs, uniq, partials, ctx.num_groups_limit,
            order_trim=planner.order_by_agg_index(ctx),
        )
        stats.num_groups = len(res.keys[0]) if res.keys else 0
        return res, stats
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


# ---------------------------------------------------------------------------
# cross-query batching (the serving tier's kernel layer)
# ---------------------------------------------------------------------------
class BatchShapeError(RuntimeError):
    """Batch members do not share one planned closure, or the closure does
    not run under torch.func.vmap: callers fall back to per-member
    execution (never a user-visible failure)."""


class BatchAudit:
    """Counts batched-closure builds against cache hits, beside SSE_AUDIT
    for the base plans: one base plan (SSE_AUDIT) + one batched closure
    (here) per query shape."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles = 0
        self.hits = 0

    def record_compile(self):
        with self._lock:
            self.compiles += 1

    def record_hit(self):
        with self._lock:
            self.hits += 1

    def reset(self):
        with self._lock:
            self.compiles = 0
            self.hits = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"compiles": self.compiles, "hits": self.hits}


BATCH_AUDIT = BatchAudit()


def batch_width() -> int:
    """The most members one batched launch takes (PINOT_TPU_BATCH_MAX,
    default 8, at least 2)."""
    return max(2, int(os.environ.get("PINOT_TPU_BATCH_MAX", "8")))


_BATCH_FN_CACHE = None


def _batch_fn_cache():
    global _BATCH_FN_CACHE
    if _BATCH_FN_CACHE is None:
        from pinot_tpu_torch.utils.cache import LruCache

        _BATCH_FN_CACHE = LruCache(
            max_entries=int(os.environ.get("PINOT_TPU_BATCH_PLAN_ENTRIES", "64")),
            name="compile.batch",
        )
    return _BATCH_FN_CACHE


def launch_segment_batch(ctxs: List[QueryContext], segment: ImmutableSegment, device: torch.device,
                         residency=None):
    """Run N same-shape queries over one segment as ONE torch.func.vmap of
    their shared planned closure: the members' literal params stack along a
    leading member axis, the segment's columns and `__valid__` are shared,
    and the fused scan's vmap rule makes one member-axis launch.  The
    batched closure lives in a bounded LRU ("compile.batch") keyed on the
    plan-cache key.

    Per-member ExecutionStats divide the launch's docs scanned and kernel
    bytes/flops across the n members, so summing member stats reproduces
    ONE unbatched run; compile_ms lands on member 0.

    Raises BatchShapeError when members do not resolve to one planned
    closure, the batch is wider than batch_width(), or the closure does not
    run under vmap (in-place scatters of the min/max and sparse paths,
    host reads of device values): callers launch the members one by one.
    Star-tree shortcuts are not taken here."""
    n = len(ctxs)
    if n < 1:
        raise ValueError("launch_segment_batch needs at least one member")
    plans = [planner.plan_segment(ctx, segment, device) for ctx in ctxs]
    base = plans[0]
    for p in plans[1:]:
        if p.fn is not base.fn or p.kind != base.kind:
            raise BatchShapeError("batch members resolved to different planned closures")
    width = batch_width()
    if n > width:
        raise BatchShapeError(f"batch of {n} exceeds lane width {width}")

    shared_keys = frozenset(k for k in base.params if k == "__valid__")
    cols = segment.to_device(device, columns=base.needed_columns, packed_codes=True, residency=residency)
    params = {
        k: _param_tensor(v0, device) if k in shared_keys
        else torch.from_numpy(np.stack([param_array(p.params[k]) for p in plans])).to(device)
        for k, v0 in base.params.items()
    }
    key = (base.cache_key or id(base.fn), shared_keys)
    cache = _batch_fn_cache()
    fnb = cache.get(key)
    first_batched = fnb is None
    if first_batched:
        axes = {k: (None if k in shared_keys else 0) for k in base.params}
        fnb = torch.func.vmap(base.fn, in_dims=(None, axes, None))
        cache.put(key, fnb)
        BATCH_AUDIT.record_compile()
    else:
        BATCH_AUDIT.record_hit()
    cost = perf.analytic_cost(
        segment.num_docs,
        perf.analytic_bytes_per_row(segment.column(nm) for nm in base.needed_columns),
        kind=base.kind,
        num_groups=base.num_groups,
        num_entries=len(base.aggs),
    )
    t0 = time.perf_counter()
    try:
        out = fnb(cols, params, device)
    except Exception as exc:  # noqa: BLE001 — any vmap refusal means "run the members one by one"
        raise BatchShapeError(f"the planned closure does not run under torch.func.vmap: {exc}") from exc
    compile_ms = (time.perf_counter() - t0) * 1000.0 if first_batched else 0.0

    docs = segment.num_docs
    share, rem = divmod(docs, n)
    stats_list = []
    for i in range(n):
        st = ExecutionStats(
            num_segments_queried=1,
            num_segments_processed=1,
            num_docs_scanned=share + (1 if i < rem else 0),
            total_docs=docs,
        )
        st.filter_index_uses = tuple(plans[i].index_uses)
        st.kernel_bytes = cost.bytes_accessed / n
        st.kernel_flops = cost.flops / n
        st.kernel_cost_source = cost.source
        stats_list.append(st)
    if first_batched:
        stats_list[0].compile_ms = compile_ms
    return ("batch", ctxs, segment, plans, out, stats_list)


def _member(x, i: int):
    """Member i's slice of a batched output tree."""
    if isinstance(x, dict):
        return {k: _member(v, i) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_member(v, i) for v in x)
    return np.asarray(x[i])


def collect_segment_batch(state):
    """Phase 2 of a batched launch: one copy home for all members, then
    each member's slice decoded by the path the unbatched collect takes —
    batched results equal sequential ones."""
    _, ctxs, segment, plans, out, stats_list = state
    if plans[0].kind == "selection":
        results = []
        for i, (ctx, plan, st) in enumerate(zip(ctxs, plans, stats_list)):
            docids = matched_docids(out[i])
            st.bytes_to_host = int(docids.nbytes)
            results.append((_gather_selection(ctx, plan, segment, docids), st))
        return results
    host = _to_host(out)
    return [
        _decode_host(ctx, segment, plan, _member(host, i), st)
        for i, (ctx, plan, st) in enumerate(zip(ctxs, plans, stats_list))
    ]


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


def sparse_tables_to_result(
    group_dims, aggs, uniq, partials, num_groups_limit: int,
    order_trim: Optional[Tuple[int, bool]] = None,
    assume_unique: bool = False,
) -> GroupBySegmentResult:
    """Decode fixed-size sparse group tables (planner.sparse_grouped_tables)
    into a GroupBySegmentResult, merging slots that share a key.

    Takes one kernel's [K] tables (keys already unique) or the
    concatenation of several launches' tables, where one key may appear in
    several (the IndexedTable merge of the reference's CombineOperator).
    Only table-sized arrays are touched.

    assume_unique: the caller merged duplicate keys already (the device
    merge, ops.sparse_merge.merge_sparse_tables): keys are unique and
    ascending and any order-aware trim is applied; this drops the empty
    padding slots and decodes."""
    uniq = np.asarray(uniq).reshape(-1)
    present = uniq != planner.SPARSE_EMPTY_KEY
    if assume_unique:
        u = uniq[present]
        if len(u) > num_groups_limit:  # defensive: the device merge trims already
            present = present & (np.cumsum(present) <= num_groups_limit)
            u = u[:num_groups_limit]
        out = [{f: np.asarray(arr)[present] for f, arr in p.items()} for p in partials]
        return GroupBySegmentResult(keys=planner.decode_packed_keys(group_dims, u), partials=out, dense=None)
    keys_flat = uniq[present]
    u, inverse = np.unique(keys_flat, return_inverse=True)
    if len(u) > num_groups_limit and order_trim is None:
        # numGroupsLimit safety valve: lowest packed keys win (with an ORDER
        # BY comparator the trim happens after the fold, over merged partials)
        keep = inverse < num_groups_limit
        u = u[:num_groups_limit]
        inverse = inverse[keep]
    else:
        keep = None
    n_groups = len(u)

    # padded per-group row matrix: mat[g] lists the slot rows carrying key g
    # (-1 padding); one vectorized combine per fold level merges every group
    counts = np.bincount(inverse, minlength=n_groups) if len(inverse) else np.zeros(n_groups, np.int64)
    maxc = int(counts.max(initial=1))
    order = np.argsort(inverse, kind="stable")
    starts = np.zeros(n_groups, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:] if n_groups > 1 else starts[:0])
    mat = np.full((n_groups, maxc), -1, dtype=np.int64)
    if len(order):
        col = np.arange(len(order)) - starts[inverse[order]]
        mat[inverse[order], col] = order

    first = np.maximum(mat[:, 0], 0)
    out: List[Dict[str, np.ndarray]] = []
    for fn, p in zip(aggs, partials):
        rows: Dict[str, np.ndarray] = {}
        for fname, arr in p.items():
            a = np.asarray(arr)[present]
            rows[fname] = a if keep is None else a[keep]
        acc = {f: a[first] for f, a in rows.items()}
        # one fold level per extra slot of a key: scalar fields, vector
        # fields ([slots, W] presence/registers/histograms) and pairwise
        # coupled partials (KMV, (t, v)) all ride it
        for j in range(1, maxc):
            validj = mat[:, j] >= 0
            if not validj.any():
                break
            idx = np.maximum(mat[:, j], 0)
            other = {f: a[idx] for f, a in rows.items()}
            if fn.pairwise_merge:
                merged = fn.merge(acc, other)
            else:
                merged = {f: combine_field(f, acc[f], other[f]) for f in acc}
            for f in acc:
                v = validj.reshape((-1,) + (1,) * (acc[f].ndim - 1))
                acc[f] = np.where(v, merged[f], acc[f])
        out.append(acc)

    if order_trim is not None and n_groups > num_groups_limit:
        sel = _order_trim_select(aggs, lambda i: out[i], u, order_trim, num_groups_limit)
        u = u[sel]
        out = [{f: a[sel] for f, a in p.items()} for p in out]
    return GroupBySegmentResult(keys=planner.decode_packed_keys(group_dims, u), partials=out, dense=None)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------
def _gather_selection(ctx: QueryContext, plan, segment: ImmutableSegment, docids: np.ndarray) -> SelectionSegmentResult:
    """Host-side row gather for selection queries over the segment's
    matched doc ids (ascending), with the per-segment trim (SelectionOnly /
    SelectionOrderBy operator analog)."""
    # window functions rank/aggregate over ALL matched rows, and UNNEST
    # drops empty-MV rows AFTER the gather: the per-segment trim would
    # change the results of both, so it is off (bounded by a valve)
    has_unnest = any(isinstance(s, Expr) and s.kind.name == "CALL" and s.op == "unnest" for s in ctx.select_list)
    if ctx.windows or has_unnest:
        cap = int(ctx.options.get("maxWindowRows", 1_000_000))
        if len(docids) > cap:
            raise ValueError(f"window/unnest query matched {len(docids)} rows > maxWindowRows={cap}")
        want = len(docids)
    else:
        want = ctx.offset + ctx.limit
    if ctx.order_by:
        if len(docids) > want:
            # Per-segment trim: WITHIN one segment dict codes are sort ranks
            # (sorted dictionary), so a stable lexsort on codes/values is a
            # correct local top-k whatever the type; expression keys
            # evaluate on the host over the matched rows.  lexsort's primary
            # key is the LAST array: (value, null_rank) per ORDER BY
            # expression, pushed in reverse significance.
            lex_keys: List[np.ndarray] = []
            for ob in reversed(ctx.order_by):
                if ob.expr.is_column:
                    value_key, null_rank = _local_order_key(segment, ob.expr.op, docids, ob.ascending, ob.nulls_last)
                else:
                    value_key, null_rank = _expr_order_key(segment, ob.expr, docids, ob.ascending, ob.nulls_last)
                lex_keys.append(value_key)
                if null_rank is not None:
                    lex_keys.append(null_rank)
            order = np.lexsort(tuple(lex_keys))[:want]
            docids = docids[order]
    else:
        docids = docids[:want]
    arrays: Dict[str, np.ndarray] = {}

    def _decoded(name: str) -> np.ndarray:
        c = segment.column(name)
        vals = c.decoded_rows(docids)
        if c.nulls is not None and ctx.null_handling:
            vals = np.asarray(vals, dtype=object)
            vals[c.nulls[docids]] = None
        return vals

    def _value_array(e) -> np.ndarray:
        return _decoded(e.op) if e.is_column else eval_expr_host(e, segment, docids)

    out_keys: List[str] = []
    items = plan.select_exprs or [Expr.col(n) for n in plan.select_columns]
    # window keys are indexed by position in ctx.select_list (what reduce
    # enumerates), not by the *-expanded item index
    win_positions = iter(i for i, s in enumerate(ctx.select_list) if isinstance(s, WindowSpec))
    for i, e in enumerate(items):
        if isinstance(e, WindowSpec):
            # placeholder output slot (reduce overwrites it after the global
            # merge) and the window's input arrays keyed by fingerprint
            key = f"__win{next(win_positions)}"
            out_keys.append(key)
            arrays[key] = np.zeros(len(docids))
            for ie in list(e.partition_by) + [o.expr for o in e.order_by] + ([e.expr] if e.expr else []):
                wkey = f"__wx_{ie.fingerprint()}"
                if wkey not in arrays:
                    arrays[wkey] = _value_array(ie)
            continue
        if e.is_column:
            out_keys.append(e.op)
            arrays[e.op] = _decoded(e.op)
            continue
        if e.kind.name == "CALL" and e.op == "unnest":
            key = f"__sel{i}"
            out_keys.append(key)
            arrays[key] = np.zeros(len(docids), dtype=object)  # filled by the explode below
            continue
        # expression select item: host evaluation over the gathered rows only
        key = f"__sel{i}"
        out_keys.append(key)
        vals = eval_expr_host(e, segment, docids)
        nmask = None
        if ctx.null_handling:
            for cname in e.columns():
                cn = segment.column(cname).nulls
                if cn is not None:
                    m = cn[docids]
                    nmask = m if nmask is None else (nmask | m)
        if nmask is not None and nmask.any():
            vals = np.asarray(vals, dtype=object)
            vals[nmask] = None
        arrays[key] = vals
    # the cross-segment merge needs real VALUES for order columns (codes are
    # segment-local); reduce re-sorts the concatenated trimmed rows
    for i, ob in enumerate(ctx.order_by):
        arrays[f"__ord{i}"] = _value_array(ob.expr)
    cols = out_keys + [f"__ord{i}" for i in range(len(ctx.order_by))]
    cols += sorted(k for k in arrays if k.startswith("__wx_"))

    # UNNEST(mvcol): each gathered row once per element (the MSE
    # UnnestOperator analog on the selection path; zero-length rows drop)
    unnest_keys = [
        (k, e) for k, e in zip(out_keys, items)
        if isinstance(e, Expr) and e.kind.name == "CALL" and e.op == "unnest"
    ]
    if unnest_keys:
        if len(unnest_keys) > 1:
            raise NotImplementedError("one UNNEST per query")
        ukey, uexpr = unnest_keys[0]
        if not (len(uexpr.args) == 1 and uexpr.args[0].is_column):
            raise NotImplementedError("UNNEST takes a bare multi-value column")
        c = segment.column(uexpr.args[0].op)
        if c.mv_lengths is None:
            raise ValueError(f"UNNEST requires a multi-value column ({uexpr.args[0].op})")
        idx = np.repeat(np.arange(len(docids)), c.mv_lengths[docids].astype(np.int64))
        elems = np.concatenate(
            [list(t) for t in c.decoded_rows(docids) if len(t)] or [np.array([], dtype=object)]
        )
        arrays = {
            k: np.asarray(elems, dtype=object) if k == ukey else np.asarray(arrays[k], dtype=object)[idx]
            for k in cols
        }
    return SelectionSegmentResult(columns=cols, arrays=arrays)


def order_key_arrays(
    codes: Optional[np.ndarray],
    values: Optional[np.ndarray],
    nulls: Optional[np.ndarray],
    docids: np.ndarray,
    ascending: bool,
    nulls_last: bool,
):
    """(value_key, null_rank) lexsort keys for ORDER BY, keeping integer
    dtypes intact (LONG values above 2^53 must not collide in a float64
    cast).  Shared by the per-segment selection trim and the distributed
    gather (codes are sort ranks within their dictionary's key space)."""
    if codes is not None:
        key = np.asarray(codes)[docids].astype(np.int64)
    else:
        key = np.asarray(values)[docids]
    if not ascending:
        key = -key.astype(np.int64) if np.issubdtype(key.dtype, np.integer) else -key.astype(np.float64)
    null_rank = None
    if nulls is not None:
        nullm = np.asarray(nulls)[docids]
        null_rank = np.where(nullm, np.int8(1 if nulls_last else -1), np.int8(0))
        key = np.where(nullm, key.dtype.type(0), key)
    return key, null_rank


def _expr_order_key(segment: ImmutableSegment, expr, docids: np.ndarray, ascending: bool, nulls_last: bool):
    """(lexsort key, null_rank) for an ORDER BY expression: host evaluation
    over the matched rows; a row is NULL when any input column is null there
    (SQL null propagation), ranked by NULLS FIRST/LAST, not by the
    placeholder value the expression computed."""
    vals = eval_expr_host(expr, segment, docids)
    nullm = None
    for cname in expr.columns():
        cn = segment.column(cname).nulls
        if cn is not None:
            m = cn[docids]
            nullm = m if nullm is None else (nullm | m)
    a = np.asarray(vals)
    if a.dtype == object:
        none_m = np.array([v is None for v in a], dtype=bool)
        if none_m.any():
            nullm = none_m if nullm is None else (nullm | none_m)
            a = a.copy()
            a[none_m] = 0
        try:
            a = a.astype(np.float64)
        except (ValueError, TypeError):
            pass
    if np.issubdtype(a.dtype, np.number):
        key = a.astype(np.float64)
        key = key if ascending else -key
    else:
        _, inv = np.unique(a.astype(str), return_inverse=True)
        key = inv if ascending else -inv
    null_rank = None
    if nullm is not None and nullm.any():
        null_rank = np.where(nullm, np.int8(1 if nulls_last else -1), np.int8(0))
        key = np.where(nullm, 0, key)
    return key, null_rank


def _local_order_key(segment: ImmutableSegment, col: str, docids: np.ndarray, ascending: bool, nulls_last: bool):
    c = segment.column(col)
    return order_key_arrays(c.codes, c.values, c.nulls, docids, ascending, nulls_last)
