"""Per-segment plan maker — the single-stage (SSE) hot path.

Port of pinot_tpu/query/planner.py for the single-table slice: aggregation
without GROUP BY and the DENSE group-by over dictionary (or small-range raw
int) columns.  Reference parity: InstancePlanMakerImplV2.makeSegmentPlanNode
picking Aggregation/GroupBy plans per query shape, plus the operator chain
(filter -> projection -> aggregation/group-by) it builds.

Where the JAX package traces the chain into one jax.jit kernel, the port
builds one Python closure over torch ops and the fused-scan kernel, and
runs it eagerly.  Plans are cached by (query SHAPE fingerprint, segment
signature, backend tag) — the JAX package's key, with the tag "cuda" or
"torch" in place of its scan backend — and a cache hit rebuilds only the
params (literals, dictionary lookups) and reuses the closure.

Group-bys whose key space passes maxDenseGroups take the SPARSE path
(``sparse_grouped_tables``): rows sorted by a packed int64 key and scattered
into fixed [numGroupsLimit] tables, with the ORDER BY-aware trim on the
device.  The distributed engine (parallel/engine.py) shares these pieces.

Aggregation inputs and group keys may be expressions (query/transform.py):
a FILTER (WHERE ...) clause gives its aggregation its own mask, a bounded
integer expression is an "expr" group dimension and a string function of a
dictionary column a "derived" one.  A query with no aggregation and no
GROUP BY is a "selection" plan: its closure returns the filter's row mask
and the executor gathers the rows (window functions are computed at reduce).

Sketches and the aggregations with extra arguments raise
NotImplementedError here, naming ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.ops import segmented as ops
from pinot_tpu_torch.ops.sparse_merge import SPARSE_EMPTY_KEY
from pinot_tpu_torch.query import scalar
from pinot_tpu_torch.query.filter import FilterCompiler
from pinot_tpu_torch.query.functions import FIELD_COMBINE, AggFunction, field_identity, for_spec
from pinot_tpu_torch.query.ir import AggregationSpec, Expr, QueryContext, WindowSpec
from pinot_tpu_torch.query.transform import as_row_array, device_constant, eval_expr
from pinot_tpu_torch.query.shape import column_info_from, params_structure
from pinot_tpu_torch.segment import packing
from pinot_tpu_torch.segment.segment import ImmutableSegment
from pinot_tpu_torch.spi.schema import DataType

_INT_TYPES = (DataType.INT, DataType.LONG, DataType.TIMESTAMP, DataType.BOOLEAN)


@dataclass
class GroupDim:
    """How one group-by dimension maps into the dense key space.

    kinds:
      dict    - dictionary codes of a column
      rawint  - integer column values shifted by base
      expr    - integer-valued device expression shifted by base (range
                bounded statically by scalar.expr_int_range)
      derived - dict column remapped through a host-computed derived
                dictionary (string functions: code -> remap[code], decoded
                via derived_values)
    """

    expr: Expr
    name: str
    kind: str  # "dict" | "rawint" | "expr" | "derived"
    cardinality: int
    dictionary: Optional[Any] = None  # Dictionary for kind=dict
    base: int = 0  # min value for kind=rawint/expr
    null_code: int = -1  # code representing SQL NULL (placeholder), -1 if none
    derived_values: Optional[np.ndarray] = None  # kind=derived decode table
    remap: Optional[np.ndarray] = None  # kind=derived code remap (int32)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if self.kind == "dict":
            card = self.dictionary.cardinality
            vals = self.dictionary.get_values(np.minimum(np.asarray(codes), card - 1))
        elif self.kind == "derived":
            vals = self.derived_values[np.minimum(np.asarray(codes), len(self.derived_values) - 1)]
        else:
            vals = codes.astype(np.int64) + self.base
        if self.null_code >= 0:
            vals = np.asarray(vals, dtype=object)
            vals[np.asarray(codes) == self.null_code] = None
        return vals

    def device_code(self, cols, segment, dev: torch.device, dtype=torch.int32) -> torch.Tensor:
        """Per-row dimension code in `dtype` (the group-key contribution)."""
        if self.kind == "dict":
            return cols[self.name]["codes"].to(dtype)
        if self.kind == "rawint":
            v = cols[self.name]["values"]
            return (v - self.base).to(dtype)  # subtract in storage dtype
        if self.kind == "derived":
            remap = device_constant(self.remap, dev)
            return remap[cols[self.name]["codes"].to(torch.int64)].to(dtype)
        v, _ = eval_expr(self.expr, segment, cols, dev)
        return (v.to(torch.int64) - self.base).to(dtype)


def group_strides(group_dims: List[GroupDim]) -> List[int]:
    """Strides of the packed composite group key (most-significant-first)."""
    strides: List[int] = []
    acc = 1
    for gd in reversed(group_dims):
        strides.append(acc)
        acc *= gd.cardinality
    return list(reversed(strides))


def decode_packed_keys(group_dims: List[GroupDim], packed: np.ndarray) -> List[np.ndarray]:
    """Packed composite keys -> per-dimension decoded value arrays."""
    packed = np.asarray(packed)
    return [
        gd.decode(((packed // stride) % gd.cardinality).astype(np.int64))
        for gd, stride in zip(group_dims, group_strides(group_dims))
    ]


@dataclass
class SegmentPlan:
    kind: str  # "aggregation" | "groupby_dense" | "groupby_sparse" | "selection"
    fn: Callable  # fn(cols, params, device) -> partials (selection: the row mask)
    params: Dict[str, Any]
    needed_columns: List[str]
    aggs: List[AggFunction] = field(default_factory=list)
    group_dims: List[GroupDim] = field(default_factory=list)
    num_groups: int = 0
    select_columns: List[str] = field(default_factory=list)
    # selection output items in order (columns, expressions and windows)
    select_exprs: List[Any] = field(default_factory=list)
    # (column, index kind) per index-accelerated filter predicate
    index_uses: List[Tuple[str, str]] = field(default_factory=list)
    cache_key: Optional[Tuple] = None


class _PlanCache:
    """Bounded LRU of planned closures."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._d: "OrderedDict[Tuple, SegmentPlan]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key) -> Optional[SegmentPlan]:
        with self._lock:
            plan = self._d.get(key)
            if plan is not None:
                self._d.move_to_end(key)
            return plan

    def put(self, key, plan: SegmentPlan) -> None:
        with self._lock:
            self._d[key] = plan
            self._d.move_to_end(key)
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)


_PLAN_CACHE = _PlanCache()


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


def backend_tag(device: torch.device) -> str:
    """Plan-time backend tag: "cuda" plans send kernel-eligible group-by
    entry sets to the fused-scan kernel; "torch" plans run plain torch."""
    return "cuda" if device.type == "cuda" else "torch"


def _sig_value(v):
    return v.item() if isinstance(v, np.generic) else v


def column_limb_sig(c) -> Optional[Tuple[int, bool]]:
    """Limb plan implied by an int column's stats — part of the plan key
    because grouped_partials bakes it into the closure."""
    if c.data_type in _INT_TYPES:
        s = c.stats
        if s.num_docs and s.min_value is not None:
            return ops.sum_limb_plan(s.min_value, s.max_value)
    return None


def _segment_signature(segment: ImmutableSegment, needed: List[str], const_cols: frozenset = frozenset()) -> Tuple:
    sig = [segment.num_docs, segment.valid_docs is not None]
    for name in sorted(needed):
        c = segment.column(name)
        # raw columns include min/max: rawint group dims bake base/cardinality
        raw_range = None
        if not c.has_dictionary and c.data_type.is_numeric:
            raw_range = (
                (_sig_value(c.stats.min_value), _sig_value(c.stats.max_value)) if c.stats.num_docs else (0, 0)
            )
        # columns whose dictionary-derived constants (derived remaps, expr
        # ranges) the closure bakes in: the dictionary and range join the key
        const_extra = None
        if name in const_cols:
            const_extra = (
                c.dictionary.fingerprint() if c.has_dictionary else None,
                _sig_value(c.stats.min_value),
                _sig_value(c.stats.max_value),
            )
        sig.append(
            (
                name,
                c.cardinality if c.has_dictionary else -1,
                str(c.codes.dtype if c.codes is not None else c.values.dtype),
                c.code_bits,
                c.nulls is not None,
                raw_range,
                const_extra,
                column_limb_sig(c),
                c.stats.is_sorted,
                tuple(sorted(k for k, by_col in segment.indexes.items() if name in by_col)),
            )
        )
    return tuple(sig)


def const_bound_columns(ctx: QueryContext) -> frozenset:
    """Columns whose dictionary values a planned closure bakes in as
    constants: any column under a dictionary-domain function (derived
    arrays) or an expression group-by (derived remaps, expr ranges).  Their
    dictionary fingerprint joins the plan-cache signature, or a same-shaped
    segment would reuse another segment's constants."""
    out = set()

    def visit(e: Optional[Expr]) -> None:
        if e is None:
            return
        if e.kind.name == "CALL":
            if e.op in scalar.DICT_FNS:
                out.update(e.columns())
            for a in e.args:
                visit(a)

    def visit_filter(node) -> None:
        if node is None:
            return
        if node.predicate is not None:
            visit(node.predicate.lhs)
        for ch in node.children:
            visit_filter(ch)

    for g in ctx.group_by:
        if not g.is_column:
            out.update(g.columns())  # expr dims bake ranges/remaps
    for spec in ctx.aggregations:
        visit(spec.expr)
        visit_filter(spec.filter)
    visit_filter(ctx.filter)
    return frozenset(out)


def _all_column_names(table_like) -> List[str]:
    """All queryable columns, INCLUDING schema-evolution virtuals that the
    segment's own (older) schema does not list."""
    cols = getattr(table_like, "columns", None)
    if isinstance(cols, dict):
        return list(cols)
    return table_like.schema.column_names


def _needed_columns(ctx: QueryContext, segment: ImmutableSegment) -> List[str]:
    cols: List[str] = []
    if ctx.filter:
        cols.extend(ctx.filter.columns())
    for g in ctx.group_by:
        cols.extend(g.columns())
    for s in list(ctx.select_list) + list(ctx.extra_aggregations):
        if isinstance(s, AggregationSpec):
            if s.expr is not None:
                cols.extend(s.expr.columns())
            if s.filter:
                cols.extend(s.filter.columns())
        elif isinstance(s, WindowSpec):
            if s.expr is not None:
                cols.extend(s.expr.columns())
            for pe in s.partition_by:
                cols.extend(pe.columns())
            for o in s.order_by:
                cols.extend(o.expr.columns())
        else:
            cols.extend(s.columns())
    # ORDER BY/HAVING references to AGGREGATION aliases resolve at reduce
    # against final arrays, not segment columns
    agg_aliases = {
        a for s, a in zip(ctx.select_list, ctx.select_aliases) if a and isinstance(s, AggregationSpec)
    }
    alias_only = agg_aliases - set(segment.schema.column_names)
    # "*" here can only come from COUNT(*) inside an ORDER BY/HAVING call,
    # which reads no column (unlike SELECT *)
    for o in ctx.order_by:
        cols.extend(c for c in o.expr.columns() if c not in alias_only and c != "*")
    if ctx.having:
        cols.extend(c for c in ctx.having.columns() if c not in alias_only and c != "*")
    seen, out = set(), []
    for c in cols:
        if c == "*":  # SELECT *
            for name in _all_column_names(segment):
                if name not in seen:
                    seen.add(name)
                    out.append(name)
            continue
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def _non_filter_columns(ctx: QueryContext, segment) -> set:
    """Columns the plan needs independent of the WHERE and FILTER clauses."""
    import dataclasses as dc

    def strip(s):
        if isinstance(s, AggregationSpec) and s.filter is not None:
            return dc.replace(s, filter=None)
        return s

    ctx2 = dc.replace(
        ctx,
        filter=None,
        select_list=[strip(s) for s in ctx.select_list],
        extra_aggregations=[strip(s) for s in ctx.extra_aggregations],
    )
    return set(_needed_columns(ctx2, segment))


def _refuse_later_slices(ctx: QueryContext) -> None:
    for spec in ctx.aggregations:
        if spec.extra_exprs or spec.literal_args:
            raise NotImplementedError(
                f"{spec.function} with extra arguments is a later slice of the port (ROADMAP Queue 1 item 4)"
            )


def _group_dim(expr: Expr, segment: ImmutableSegment, null_handling: bool) -> GroupDim:
    if expr.is_column:
        c = segment.column(expr.op)
        if c.has_dictionary:
            null_code = -1
            if c.nulls is not None and null_handling:
                nc = c.dictionary.index_of(c.data_type.null_placeholder)
                if nc >= 0:
                    null_code = nc
            return GroupDim(expr, c.name, "dict", c.dictionary.cardinality, dictionary=c.dictionary,
                            null_code=null_code)
        if c.data_type in _INT_TYPES:
            lo, hi = int(c.stats.min_value), int(c.stats.max_value)
            return GroupDim(expr, c.name, "rawint", hi - lo + 1, base=lo)
        raise NotImplementedError(f"group-by on raw {c.data_type.value} column {c.name} is not groupable")
    # GROUP BY <expression>: a string-valued dictionary function is a
    # derived dictionary dimension
    if scalar.is_dict_fn_expr(expr) and scalar.string_result(expr):
        col = next(a for a in expr.args if not a.is_literal).op
        c = segment.column(col)
        if c.has_dictionary:
            derived = scalar.derived_for(expr, c.dictionary)
            uniq, remap = np.unique(derived, return_inverse=True)
            return GroupDim(expr, col, "derived", len(uniq), derived_values=uniq, remap=remap.astype(np.int32))
    # an integer-valued device expression is a statically bounded dimension
    # (GROUP BY DATETRUNC('day', ts), MOD(d, 100))
    rng = scalar.expr_int_range(expr, segment)
    if rng is not None:
        lo, hi = rng
        return GroupDim(expr, str(expr), "expr", hi - lo + 1, base=lo)
    raise NotImplementedError(
        f"group-by expression {expr} is not supported: its integer range cannot be "
        "bounded from column stats and it is not a dictionary string function"
    )


def agg_vranges(agg_specs, table_like) -> List[Optional[Tuple[int, int]]]:
    """Per-aggregation (min, max) column stats when the input is a bare int
    column — they pick the limb plan the fused scan reads the value with."""
    out: List[Optional[Tuple[int, int]]] = []
    for spec in agg_specs:
        rng = None
        e = spec.expr
        if e is not None and e.is_column and e.op != "*":
            try:
                c = table_like.column(e.op)
            except KeyError:
                c = None
            if c is not None and c.data_type in _INT_TYPES:
                s = c.stats
                if s.num_docs and s.min_value is not None:
                    rng = (int(s.min_value), int(s.max_value))
        out.append(rng)
    return out


def _is_int(t: torch.Tensor) -> bool:
    return not t.is_floating_point() and t.dtype != torch.bool


def words_fusable(aggs) -> bool:
    """Every field of every aggregation is one the fused scan makes (count,
    sum, sum of squares), so a filter's packed words can go to the scan."""
    return all(k in ("count", "sum", "sumsq") for fn in aggs for k in fn.field_kinds.values())


def grouped_partials(aggs, inputs, tmask, key_fn, num_groups: int, vranges,
                     backend=None, key_packed=None, mask_words=None):
    """Presence table + per-agg grouped partial dicts for the dense path.

    All additive fields (presence, counts, sums, sums of squares) of ALL
    aggregations share ONE fused scan (ops.fused_group_tables); min/max
    fields scatter.  Entries dedup by tensor identity, so COUNT(*) shares the
    presence entry.  key_fn() returns the group-key codes; it is called only
    when something reads them — eager torch has no dead-code elimination, so
    a packed key (key_packed = (words, code_bits)) that the kernel reads
    in-register is never unpacked for nothing.

    mask_words optionally carries the filter as packed bitmap words (int32
    views) instead of folded into tmask and the input masks: the fused scan
    reads them in-register.  The min/max scatters never see packed words, so
    when any aggregation needs a field the scan does not make, the words are
    unpacked here and ANDed into the masks (shared masks stay shared)."""
    if mask_words is not None:
        if not words_fusable(aggs):
            row_mask = ops.unpack_bitmap_words(mask_words, int(tmask.shape[0]))
            anded: Dict[int, torch.Tensor] = {}

            def _and(m):
                if id(m) not in anded:
                    anded[id(m)] = m & row_mask
                return anded[id(m)]

            tmask = _and(tmask)
            inputs = [(v, _and(m)) for v, m in inputs]
            mask_words = None
    entries: List[Tuple] = []
    slot_of: Dict[Tuple, int] = {}

    def entry_slot(kind, values, mask, limb_plan=None) -> int:
        k = (kind, id(values) if values is not None else None, id(mask), limb_plan)
        idx = slot_of.get(k)
        if idx is None:
            idx = len(entries)
            entries.append((kind, values, mask, limb_plan))
            slot_of[k] = idx
        return idx

    presence_idx = entry_slot("count", None, tmask)
    requests: List[Dict[str, Tuple[str, Optional[int]]]] = []
    for i, (fn, (vals, mask)) in enumerate(zip(aggs, inputs)):
        fmap: Dict[str, Tuple[str, Optional[int]]] = {}
        for fname, kind in fn.field_kinds.items():
            if kind == "count":
                fmap[fname] = ("fused", entry_slot("count", None, mask))
            elif kind == "sum":
                v = vals
                rng = vranges[i] if i < len(vranges) else None
                if _is_int(v) and v.element_size() > 4 and rng is not None and (
                    -(1 << 31) <= rng[0] and rng[1] < (1 << 31)
                ):
                    v = v.to(torch.int32)  # stats prove int32 narrowing safe
                if _is_int(v) and v.element_size() <= 4:
                    lp = ops.sum_limb_plan(*rng) if rng is not None else (4, True)
                    fmap[fname] = ("fused", entry_slot("int_sum", v, mask, lp))
                elif _is_int(v):
                    nl = ops.sum_limb_plan64(*rng) if rng is not None else 8
                    fmap[fname] = ("fused", entry_slot("int64_sum", v, mask, nl))
                else:
                    fmap[fname] = ("fused", entry_slot("f32_sum", vals, mask))
            elif kind == "sumsq":
                fmap[fname] = ("fused", entry_slot("f32_sumsq", vals, mask))
            else:
                fmap[fname] = (kind, None)  # min/max: scatter below
        requests.append(fmap)

    tables = ops.fused_group_tables(
        entries, None if key_packed is not None else key_fn(), num_groups,
        backend=backend, mask_words=mask_words, codes_packed=key_packed,
    )

    def _as_table(idx):
        t = tables[idx]
        return t.to(torch.int64) if entries[idx][0] == "count" else t

    presence = _as_table(presence_idx)
    partials: List[Dict] = []
    for fmap, (vals, mask) in zip(requests, inputs):
        p: Dict[str, Any] = {}
        for fname, (k2, idx) in fmap.items():
            if k2 == "fused":
                p[fname] = _as_table(idx)
            elif k2 == "min":
                p[fname] = ops.group_min(vals, mask, key_fn(), num_groups)
            else:
                p[fname] = ops.group_max(vals, mask, key_fn(), num_groups)
        partials.append(p)
    return presence, partials


def make_agg_inputs(agg_specs, aggs, agg_filter_fns, table_like, null_handling: bool):
    """Per-aggregation (values, mask) builder over a plan's device columns,
    with FILTER (WHERE ...) and null handling (the projection and transform
    step of the hot loop); shared by the segment plans and the distributed
    engine's.  agg_filter_fns holds each aggregation's compiled FILTER
    clause or None.  Aggregations with the same FILTER clause share one
    mask tensor, so the fused scan reads it once."""

    def _agg_inputs(cols, params, base_mask, dev):
        out = []
        filtered: Dict[str, torch.Tensor] = {}
        for spec, fn, ffn in zip(agg_specs, aggs, agg_filter_fns):
            mask = base_mask
            if ffn is not None:
                fp = spec.filter.fingerprint()
                if fp not in filtered:
                    ft, _ = ffn(cols, params, dev)
                    filtered[fp] = mask & ft
                mask = filtered[fp]
            if spec.expr is None:
                vals = mask  # COUNT(*): values unused
            elif fn.name == "count" and spec.expr.is_column:
                # COUNT(col) needs only the null mask — works on strings too
                vals = mask
                c = table_like.column(spec.expr.op)
                if c.nulls is not None and null_handling:
                    mask = mask & ~cols[spec.expr.op]["nulls"]
            else:
                vals, nulls = eval_expr(spec.expr, table_like, cols, dev)
                vals = as_row_array(vals, mask)
                if nulls is not None and null_handling:
                    mask = mask & ~nulls
            out.append((vals, mask))
        return out

    return _agg_inputs


def order_by_agg_index(ctx: QueryContext) -> Optional[Tuple[int, bool]]:
    """Map the FIRST ORDER BY expression to an index into ctx.aggregations
    (by alias or by call shape) — the numGroupsLimit trim ranks by it."""
    if not ctx.order_by:
        return None
    ob = ctx.order_by[0]
    e = ob.expr
    specs = list(ctx.aggregations)
    if e.is_column:
        for s, a in zip(ctx.select_list, ctx.select_aliases):
            if a == e.op and isinstance(s, AggregationSpec):
                fp = s.fingerprint()
                for i, sp in enumerate(specs):
                    if sp.fingerprint() == fp:
                        return i, ob.ascending
        return None
    if e.kind.name != "CALL":
        return None
    for i, sp in enumerate(specs):
        if sp.filter is not None or sp.extra_exprs or sp.literal_args:
            continue
        if e.op.lower() != sp.function.lower():
            continue
        if sp.expr is None:
            if not e.args or (len(e.args) == 1 and e.args[0].is_column and e.args[0].op == "*"):
                return i, ob.ascending
        elif len(e.args) == 1 and e.args[0].fingerprint() == sp.expr.fingerprint():
            return i, ob.ascending
    return None


def guard_sparse_vector_fields(kind: str, aggs: List[AggFunction]) -> None:
    """Pre-plan check for the sparse group path: only field-wise partials
    (count/sum/sumsq/min/max fields) ride its scatters.  The sketch families
    whose per-slot vector fields the JAX package scatters there are a later
    slice of the port (slice 4)."""
    if kind != "groupby_sparse":
        return
    for fn in aggs:
        if fn.field_kinds is None or getattr(fn, "pairwise_merge", False):
            raise NotImplementedError(
                f"{fn.name} on the sparse group-by path is a later slice of the port (slice 4)"
            )


def bind_aggs(agg_specs, table_like, ctx: QueryContext) -> List[AggFunction]:
    """The aggregation functions of one plan.  Column binding (the sketch
    functions' per-column key spaces) comes with those functions, a later
    slice of the port (slice 4)."""
    out = []
    for spec in agg_specs:
        fn = for_spec(spec)
        if getattr(fn, "needs_binding", False):
            raise NotImplementedError(f"{spec.function} needs column binding, a later slice of the port (slice 4)")
        out.append(fn)
    return out


def kernel_order_spec(ctx: QueryContext, aggs: List[AggFunction]) -> Optional[Tuple[int, str, bool]]:
    """(agg index, contribution mode, ascending) when the first ORDER BY key
    is an aggregate whose per-group order value the sparse path can derive
    in one pass: additive sum/count via a segment cumsum, min/max via a
    secondary sort key.  None falls back to the lowest-packed-key trim."""
    hit = order_by_agg_index(ctx)
    if hit is None:
        return None
    i, asc = hit
    fn = aggs[i]
    mode = {"sum": "sum", "count": "count", "min": "min", "max": "max"}.get(fn.name)
    if mode is None or getattr(fn, "mv_input", False) or getattr(fn, "needs_extra_exprs", False):
        return None
    return i, mode, asc


def packed_key64(cols, group_dims: List[GroupDim], segment, dev: torch.device) -> torch.Tensor:
    """Per-dimension codes raveled into one int64 key (the planner keeps the
    key space below 2^62 before it picks the sparse path)."""
    key = None
    for gd in group_dims:
        code = gd.device_code(cols, segment, dev, torch.int64)
        key = code if key is None else key * gd.cardinality + code
    return key


def _sort_by(primary: torch.Tensor, secondary: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable lexicographic argsort by (primary, secondary): two stable
    sorts, the secondary key first (lax.sort with num_keys=2).  Ties in both
    keep the input order."""
    if secondary is None:
        return torch.sort(primary, stable=True).indices
    p1 = torch.sort(secondary, stable=True).indices
    return p1[torch.sort(primary[p1], stable=True).indices]


def sparse_grouped_tables(aggs, inputs, tmask, key, num_slots: int, order_spec=None):
    """High-cardinality group-by on the device: sort + segment-scatter into
    FIXED-size tables (the IndexedTable analog with the numGroupsLimit trim
    inside).

    Rows sort by packed key (filtered rows get SPARSE_EMPTY_KEY and sort
    last); a group starts where the sorted key changes; the running group
    index is the cumsum of the starts; rows of groups past num_slots go to a
    dropped overflow slot.  Without an order spec the lowest packed keys win.
    With one (kernel_order_spec), each group's order value is computed in
    row space and the groups ranked by (order value, packed key); the top
    num_slots get slots.  Empty (SQL NULL) and NaN order values rank last.

    Counts accumulate in int64, sums and sums of squares in float64 (exact
    for integer sums below 2^53), min/max in float64.

    Returns (uniq_keys int64[num_slots] with SPARSE_EMPTY_KEY padding,
    [{field: table[num_slots]}] per aggregation)."""
    n = int(tmask.shape[0])
    dev = tmask.device
    f64 = torch.float64
    inf = torch.full((), float("inf"), dtype=f64, device=dev)
    k64 = torch.where(tmask, key.to(torch.int64), torch.full((), SPARSE_EMPTY_KEY, dtype=torch.int64, device=dev))
    iota = torch.arange(n, device=dev)
    if order_spec is not None and order_spec[1] in ("min", "max"):
        # the min/max order value rides the row sort as a secondary key:
        # after sorting by (key, +-value) a group's extremum is its first row
        oi, omode, _ = order_spec
        ov_raw, om = inputs[oi]
        ovr = ov_raw.to(f64)
        ovr = torch.where(om, ovr if omode == "min" else -ovr, inf)
        perm = _sort_by(k64, ovr)
        skey, sov = k64[perm], ovr[perm]
    else:
        sov = None
        skey, perm = torch.sort(k64, stable=True)
    smask = tmask[perm]
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), skey[:-1]])
    is_start = smask & (skey != prev)
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    overflow = torch.full((), num_slots, dtype=torch.int64, device=dev)
    if order_spec is None:
        slot = torch.where(smask & (seg < num_slots), seg, overflow)
    else:
        oi, omode, asc = order_spec
        if sov is not None:
            empty = torch.isinf(sov)  # no agg-mask rows in the group: NULL
            group_ov = sov if asc else -sov
            if omode == "max":  # sov carries -v for max
                group_ov = -group_ov
            group_ov = torch.clamp(torch.where(empty | torch.isnan(group_ov), inf, group_ov), -1e300, 1e300)
        else:
            ov_raw, om = inputs[oi]
            isn = None
            if omode == "count":
                c = om.to(f64)
            else:
                cv = (ov_raw if ov_raw.dim() else ov_raw.expand(n)).to(f64)
                # NaN rows stay out of the cumsum (one NaN would poison every
                # later group's prefix) and are tracked per group instead
                isn = torch.isnan(cv)
                c = torch.where(om & ~isn, cv, torch.zeros((), dtype=f64, device=dev))

            def _prefix(x):
                return torch.cat([torch.zeros(1, dtype=f64, device=dev), torch.cumsum(x[perm], 0)])

            s0 = _prefix(c)
            # each group's first row, n past the last group; at a start row
            # the next group's first row is where the group's prefix ends
            # (the JAX package takes the same index from a reversed cummin)
            first_row = torch.full((n + 2,), n, dtype=torch.int64, device=dev).scatter_(
                0, torch.where(is_start, seg, torch.full((), n + 1, dtype=torch.int64, device=dev)), iota
            )
            nxt = first_row[(seg + 1).clamp(0, n)]
            group_ov = s0[nxt] - s0[iota]  # valid at start rows
            group_ov = group_ov if asc else -group_ov
            if omode == "sum":
                # SUM over zero agg-mask rows is SQL NULL, and a group that
                # saw a NaN (or overflowed to inf) ranks last
                m0 = _prefix(om.to(f64))
                n0 = _prefix((isn & om).to(f64))
                bad = ((n0[nxt] - n0[iota]) > 0) | torch.isnan(group_ov) | ((m0[nxt] - m0[iota]) <= 0)
                group_ov = torch.clamp(torch.where(bad, inf, group_ov), -1e300, 1e300)
        ovkey = torch.where(is_start, group_ov, inf)
        # rank groups by (order value, packed key): skey is already sorted,
        # so a stable sort by the order value breaks ties by key
        rorder = torch.sort(ovkey, stable=True).indices
        sovk, sseg = ovkey[rorder], seg[rorder]
        rank = torch.clamp(iota, max=num_slots)
        ranks = torch.full((n + 1,), num_slots, dtype=torch.int64, device=dev).scatter_(
            0, torch.where(torch.isfinite(sovk), sseg, torch.full((), n, dtype=torch.int64, device=dev)), rank
        )
        gslot = ranks[seg.clamp(0, n)]
        slot = torch.where(smask & (gslot < num_slots), gslot, overflow)
    uniq = torch.full((num_slots + 1,), SPARSE_EMPTY_KEY, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(is_start, slot, overflow), skey
    )
    partials = []
    for fn, (vals, mask) in zip(aggs, inputs):
        m = mask[perm]
        v = (vals if vals.dim() else vals.expand(n))[perm]
        p: Dict[str, torch.Tensor] = {}
        for fname in fn.field_kinds:
            comb = FIELD_COMBINE[fname]
            if comb == "add":
                if fname == "count":
                    acc = torch.zeros(num_slots + 1, dtype=torch.int64, device=dev).index_add_(
                        0, slot, m.to(torch.int64)
                    )
                else:
                    w = v.to(f64)
                    if fname == "sumsq":
                        w = w * w
                    acc = torch.zeros(num_slots + 1, dtype=f64, device=dev).index_add_(
                        0, slot, torch.where(m, w, torch.zeros((), dtype=f64, device=dev))
                    )
            else:
                ident = torch.full((), field_identity(fname), dtype=f64, device=dev)
                acc = ident.repeat(num_slots + 1).scatter_reduce_(
                    0, slot, torch.where(m, v.to(f64), ident),
                    reduce="amin" if comb == "min" else "amax", include_self=True,
                )
            p[fname] = acc[:num_slots]
        partials.append(p)
    return uniq[:num_slots], partials


class _LazyCodes(dict):
    """A packed column's device entry that unpacks "codes" from its lane
    words on first read, once per plan run (never cached on the segment)."""

    def __init__(self, entry, bits: int, n: int):
        super().__init__(entry)
        self._bits = bits
        self._n = n

    def __missing__(self, key):
        if key != "codes":
            raise KeyError(key)
        codes = packing.unpack_codes_torch(dict.__getitem__(self, "codes_packed"), self._bits, self._n)
        self["codes"] = codes
        return codes


def packed_code_bits(table_like, names) -> Dict[str, int]:
    """Code bits of each named column whose dictionary codes ship packed."""
    out: Dict[str, int] = {}
    for name in names:
        c = table_like.column(name)
        if c.code_bits and c.packed is not None:
            out[name] = int(c.code_bits)
    return out


def overlay_unpacked(cols, packed_meta: Dict[str, int], num_rows: int):
    """`cols` with every packed-only code entry wrapped to unpack "codes"
    on its first read (_LazyCodes)."""
    out = dict(cols)
    for name, bits in packed_meta.items():
        e = out.get(name)
        if e is not None and "codes_packed" in e and "codes" not in e:
            out[name] = _LazyCodes(e, bits, num_rows)
    return out


def plan_groups(ctx: QueryContext, table_like, aggs) -> Tuple[str, List[GroupDim], int]:
    """(kind, group dims, dense key-space size) of one plan: aggregation,
    selection (no aggregation, no GROUP BY), groupby_dense up to
    maxDenseGroups keys, else groupby_sparse."""
    if not ctx.group_by:
        return ("aggregation" if ctx.is_aggregate else "selection"), [], 0
    group_dims = [_group_dim(g, table_like, ctx.null_handling) for g in ctx.group_by]
    num_groups = 1
    for gd in group_dims:
        num_groups *= max(1, gd.cardinality)
    kind = "groupby_dense" if num_groups <= ctx.max_dense_groups else "groupby_sparse"
    guard_sparse_vector_fields(kind, aggs)
    return kind, group_dims, num_groups


def group_key(cols, group_dims: List[GroupDim], segment, dev: torch.device) -> torch.Tensor:
    """Per-row dense int32 group key; a single dict dimension passes its
    codes through in their storage dtype (the kernel and scatters read it as
    is)."""
    if len(group_dims) == 1 and group_dims[0].kind == "dict":
        return cols[group_dims[0].name]["codes"]
    key = None
    for gd in group_dims:
        code = gd.device_code(cols, segment, dev)
        key = code if key is None else key * gd.cardinality + code
    return key


def lazy_group_key(cols, group_dims: List[GroupDim], segment, dev: torch.device) -> Callable[[], torch.Tensor]:
    """group_key(...) built on the first call and reused after (the fused
    scan on packed words never needs it)."""
    box: List[torch.Tensor] = []

    def key_fn():
        if not box:
            box.append(group_key(cols, group_dims, segment, dev))
        return box[0]

    return key_fn


def key_packed(cols, group_dims: List[GroupDim], packed_meta: Dict[str, int], num_rows: int,
               backend: str) -> Optional[Tuple[torch.Tensor, int]]:
    """(words, code_bits) when the single dict group key shipped packed,
    its lanes cover `num_rows` whole words and the plan runs on the kernel
    backend; else None."""
    if backend != "cuda" or len(group_dims) != 1:
        return None
    gd = group_dims[0]
    bits = packed_meta.get(gd.name)
    if gd.kind != "dict" or not bits or num_rows % (32 // bits):
        return None
    e = cols.get(gd.name)
    if e is None or "codes_packed" not in e:
        return None
    return (e["codes_packed"], bits)


def sparse_tables_fn(ctx: QueryContext, aggs, group_dims: List[GroupDim], num_groups: int, agg_inputs, segment):
    """The sparse group path's per-launch step, (cols, params, tmask, dev)
    -> (uniq keys, partial tables) of numGroupsLimit slots, with its slot
    count and ORDER BY-aware trim spec (kernel_order_spec)."""
    if num_groups >= (1 << 62):
        raise NotImplementedError("composite group key exceeds 62 bits")
    num_slots = min(ctx.num_groups_limit, num_groups)
    order_spec = kernel_order_spec(ctx, aggs)

    def tables(cols, params, tmask, dev):
        key = packed_key64(cols, group_dims, segment, dev)
        return sparse_grouped_tables(aggs, agg_inputs(cols, params, tmask, dev), tmask, key, num_slots, order_spec)

    return tables, num_slots, order_spec


def plan_segment(ctx: QueryContext, segment: ImmutableSegment, device: torch.device) -> SegmentPlan:
    """Plan one query over one segment for `device` (cached by shape)."""
    _refuse_later_slices(ctx)
    needed = _needed_columns(ctx, segment)
    key = (
        ctx.shape_fingerprint(column_info_from(segment)),
        _segment_signature(segment, needed, const_bound_columns(ctx)),
        backend_tag(device),
    )
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        # params are per-query/per-segment: rebuild them, reuse the closure
        plan = _build_plan(ctx, segment, needed, key[2], planned_fn=cached.fn)
        if params_structure(plan.params) == params_structure(cached.params):
            plan.cache_key = key
            return plan
    plan = _build_plan(ctx, segment, needed, key[2], planned_fn=None)
    plan.cache_key = key
    _PLAN_CACHE.put(key, plan)
    return plan


def selection_items(ctx: QueryContext, table_like) -> Tuple[List[Any], List[str]]:
    """(select_exprs, select_columns) of a selection plan: the output items
    in order, SELECT * expanded to every column, window items kept (they are
    computed at reduce over the merged rows); and the bare columns among
    them."""
    select_exprs: List[Any] = []
    for s in ctx.select_list:
        if isinstance(s, WindowSpec):
            select_exprs.append(s)
            continue
        if not isinstance(s, Expr):
            raise NotImplementedError(f"unsupported selection item {s}")
        if s.kind.name == "CALL" and s.op == "unnest":
            raise NotImplementedError("UNNEST (the MV explode) is a later slice of the port (ROADMAP Queue 1 item 5)")
        if s.is_column and s.op == "*":
            select_exprs.extend(Expr.col(n) for n in _all_column_names(table_like))
        else:
            select_exprs.append(s)
    return select_exprs, [e.op for e in select_exprs if isinstance(e, Expr) and e.is_column]


def _build_plan(
    ctx: QueryContext,
    segment: ImmutableSegment,
    needed: List[str],
    backend: str,
    planned_fn: Optional[Callable],
) -> SegmentPlan:
    null_handling = ctx.null_handling
    fc = FilterCompiler(segment, null_handling)
    filter_fn = fc.compile(ctx.filter)
    agg_specs = list(ctx.aggregations)
    aggs = bind_aggs(agg_specs, segment, ctx)
    # per-aggregation FILTER (WHERE ...) clauses, compiled after the WHERE
    agg_filter_fns = [fc.compile(spec.filter) if spec.filter is not None else None for spec in agg_specs]

    # columns touched ONLY by index-resolved predicates never ship
    keep = _non_filter_columns(ctx, segment) | fc.used_columns
    needed = [c for c in needed if c in keep]

    kind, group_dims, num_groups = plan_groups(ctx, segment, aggs)
    if kind != "selection" and ctx.windows:
        raise NotImplementedError("window functions apply to selection queries only")
    if kind == "selection":
        # the selection closure reads only the filter's columns; the rows
        # gather on the host (executor._gather_selection)
        needed = [c for c in needed if c in fc.used_columns]
    packed_meta = packed_code_bits(segment, needed)
    num_docs = segment.num_docs
    _agg_inputs = make_agg_inputs(agg_specs, aggs, agg_filter_fns, segment, null_handling)

    if kind == "aggregation":

        def kernel(cols, params, dev):
            cols = overlay_unpacked(cols, packed_meta, num_docs)
            tmask, _ = filter_fn(cols, params, dev)
            return [fn.partial(vals, mask) for fn, (vals, mask) in zip(aggs, _agg_inputs(cols, params, tmask, dev))]

    elif kind == "selection":

        def kernel(cols, params, dev):
            tmask, _ = filter_fn(overlay_unpacked(cols, packed_meta, num_docs), params, dev)
            return tmask

    elif kind == "groupby_sparse":
        # sort + scatter into fixed [numGroupsLimit] tables on the device: no
        # row-length array leaves it (sparse_grouped_tables)
        tables, _, _ = sparse_tables_fn(ctx, aggs, group_dims, num_groups, _agg_inputs, segment)

        def kernel(cols, params, dev):
            cols = overlay_unpacked(cols, packed_meta, num_docs)
            tmask, _ = filter_fn(cols, params, dev)
            return tables(cols, params, tmask, dev)

    else:
        vranges = agg_vranges(agg_specs, segment)

        def kernel(cols, params, dev):
            cols = overlay_unpacked(cols, packed_meta, num_docs)
            tmask, _ = filter_fn(cols, params, dev)
            return grouped_partials(
                aggs, _agg_inputs(cols, params, tmask, dev), tmask, lazy_group_key(cols, group_dims, segment, dev),
                num_groups, vranges, backend=backend,
                key_packed=key_packed(cols, group_dims, packed_meta, num_docs, backend),
            )

    select_exprs, select_columns = selection_items(ctx, segment) if kind == "selection" else ([], [])
    return SegmentPlan(
        kind=kind,
        fn=planned_fn if planned_fn is not None else kernel,
        params=fc.params,
        needed_columns=needed,
        aggs=aggs,
        group_dims=group_dims,
        num_groups=num_groups,
        select_columns=select_columns,
        select_exprs=select_exprs,
        index_uses=list(fc.index_uses),
    )
