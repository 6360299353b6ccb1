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

Shapes of later slices raise NotImplementedError here, naming the slice:
selection queries, transforms and FILTER(WHERE) (slice 2), sketches and the
extended aggregations (slice 4), the sparse group-by (slice 1 of the
ROADMAP's queue: macro-batched engine + sparse path).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.ops import segmented as ops
from pinot_tpu_torch.query.filter import FilterCompiler, eval_column
from pinot_tpu_torch.query.functions import AggFunction, for_spec
from pinot_tpu_torch.query.ir import AggregationSpec, Expr, QueryContext
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
    """

    expr: Expr
    name: str
    kind: str  # "dict" | "rawint"
    cardinality: int
    dictionary: Optional[Any] = None  # Dictionary for kind=dict
    base: int = 0  # min value for kind=rawint
    null_code: int = -1  # code representing SQL NULL (placeholder), -1 if none

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if self.kind == "dict":
            card = self.dictionary.cardinality
            vals = self.dictionary.get_values(np.minimum(np.asarray(codes), card - 1))
        else:
            vals = codes.astype(np.int64) + self.base
        if self.null_code >= 0:
            vals = np.asarray(vals, dtype=object)
            vals[np.asarray(codes) == self.null_code] = None
        return vals

    def device_code(self, cols) -> torch.Tensor:
        """Per-row dimension code as int32 (the group-key contribution)."""
        if self.kind == "dict":
            return cols[self.name]["codes"].to(torch.int32)
        v = cols[self.name]["values"]
        return (v - self.base).to(torch.int32)  # subtract in storage dtype


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
    kind: str  # "aggregation" | "groupby_dense"
    fn: Callable  # fn(cols, params, device) -> partials
    params: Dict[str, Any]
    needed_columns: List[str]
    aggs: List[AggFunction] = field(default_factory=list)
    group_dims: List[GroupDim] = field(default_factory=list)
    num_groups: int = 0
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


def _segment_signature(segment: ImmutableSegment, needed: List[str]) -> Tuple:
    sig = [segment.num_docs, segment.valid_docs is not None]
    for name in sorted(needed):
        c = segment.column(name)
        # raw columns include min/max: rawint group dims bake base/cardinality
        raw_range = None
        if not c.has_dictionary and c.data_type.is_numeric:
            raw_range = (
                (_sig_value(c.stats.min_value), _sig_value(c.stats.max_value)) if c.stats.num_docs else (0, 0)
            )
        sig.append(
            (
                name,
                c.cardinality if c.has_dictionary else -1,
                str(c.codes.dtype if c.codes is not None else c.values.dtype),
                c.code_bits,
                c.nulls is not None,
                raw_range,
                column_limb_sig(c),
                c.stats.is_sorted,
                tuple(sorted(k for k, by_col in segment.indexes.items() if name in by_col)),
            )
        )
    return tuple(sig)


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
        else:
            cols.extend(s.columns())
    # ORDER BY/HAVING references to AGGREGATION aliases resolve at reduce
    # against final arrays, not segment columns
    agg_aliases = {
        a for s, a in zip(ctx.select_list, ctx.select_aliases) if a and isinstance(s, AggregationSpec)
    }
    alias_only = agg_aliases - set(segment.schema.column_names)
    for o in ctx.order_by:
        cols.extend(c for c in o.expr.columns() if c not in alias_only and c != "*")
    if ctx.having:
        cols.extend(c for c in ctx.having.columns() if c not in alias_only and c != "*")
    seen, out = set(), []
    for c in cols:
        if c == "*":
            continue  # COUNT(*) reads no column
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def _non_filter_columns(ctx: QueryContext, segment) -> set:
    """Columns the plan needs independent of the WHERE clause."""
    import dataclasses as dc

    return set(_needed_columns(dc.replace(ctx, filter=None), segment))


def _refuse_later_slices(ctx: QueryContext) -> None:
    if not ctx.is_aggregate:
        raise NotImplementedError("selection queries are a later slice of the port (slice 2)")
    for spec in ctx.aggregations:
        if spec.filter is not None:
            raise NotImplementedError("FILTER(WHERE ...) aggregations are a later slice of the port (slice 2)")
        if spec.expr is not None and not spec.expr.is_column:
            raise NotImplementedError(
                f"aggregation over expression {spec.expr} needs transforms, a later slice of the port (slice 2)"
            )
        if spec.extra_exprs or spec.literal_args:
            raise NotImplementedError(
                f"{spec.function} with extra arguments is a later slice of the port (slice 4)"
            )
    for g in ctx.group_by:
        if not g.is_column:
            raise NotImplementedError(
                f"GROUP BY expression {g} needs transforms, a later slice of the port (slice 2)"
            )


def _group_dim(expr: Expr, segment: ImmutableSegment, null_handling: bool) -> GroupDim:
    c = segment.column(expr.op)
    if c.has_dictionary:
        null_code = -1
        if c.nulls is not None and null_handling:
            nc = c.dictionary.index_of(c.data_type.null_placeholder)
            if nc >= 0:
                null_code = nc
        return GroupDim(expr, c.name, "dict", c.dictionary.cardinality, dictionary=c.dictionary, null_code=null_code)
    if c.data_type in _INT_TYPES:
        lo, hi = int(c.stats.min_value), int(c.stats.max_value)
        return GroupDim(expr, c.name, "rawint", hi - lo + 1, base=lo)
    raise NotImplementedError(f"group-by on raw {c.data_type.value} column {c.name} is not groupable")


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


def grouped_partials(aggs, inputs, tmask, key_fn, num_groups: int, vranges,
                     backend=None, key_packed=None):
    """Presence table + per-agg grouped partial dicts for the dense path.

    All additive fields (presence, counts, sums, sums of squares) of ALL
    aggregations share ONE fused scan (ops.fused_group_tables); min/max
    fields scatter.  Entries dedup by tensor identity, so COUNT(*) shares the
    presence entry.  key_fn() returns the group-key codes; it is called only
    when something reads them — eager torch has no dead-code elimination, so
    a packed key (key_packed = (words, code_bits)) that the kernel reads
    in-register is never unpacked for nothing."""
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
        backend=backend, codes_packed=key_packed,
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


def plan_segment(ctx: QueryContext, segment: ImmutableSegment, device: torch.device) -> SegmentPlan:
    """Plan one query over one segment for `device` (cached by shape)."""
    _refuse_later_slices(ctx)
    needed = _needed_columns(ctx, segment)
    key = (
        ctx.shape_fingerprint(column_info_from(segment)),
        _segment_signature(segment, needed),
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
    aggs = [for_spec(spec) for spec in agg_specs]

    # columns touched ONLY by index-resolved predicates never ship
    keep = _non_filter_columns(ctx, segment) | fc.used_columns
    needed = [c for c in needed if c in keep]

    packed_meta: Dict[str, int] = {}
    for name in needed:
        c = segment.column(name)
        if c.code_bits and c.packed is not None:
            packed_meta[name] = int(c.code_bits)
    num_docs = segment.num_docs

    def _overlay_unpacked(cols):
        out = dict(cols)
        for name, bits in packed_meta.items():
            e = out.get(name)
            if e is not None and "codes_packed" in e and "codes" not in e:
                out[name] = _LazyCodes(e, bits, num_docs)
        return out

    if not ctx.group_by:
        kind = "aggregation"
        group_dims: List[GroupDim] = []
        num_groups = 0
    else:
        group_dims = [_group_dim(g, segment, null_handling) for g in ctx.group_by]
        num_groups = 1
        for gd in group_dims:
            num_groups *= max(1, gd.cardinality)
        if num_groups > ctx.max_dense_groups:
            raise NotImplementedError(
                f"{num_groups} groups exceed maxDenseGroups={ctx.max_dense_groups}: the sparse "
                "group-by is a later slice of the port (slice 1 of the queue)"
            )
        kind = "groupby_dense"

    def _agg_inputs(cols, base_mask):
        """Per-aggregation (values, mask) with null handling."""
        out = []
        for spec, fn in zip(agg_specs, aggs):
            mask = base_mask
            if spec.expr is None:
                vals = mask  # COUNT(*): values unused
            elif fn.name == "count":
                # COUNT(col) needs only the null mask — works on strings too
                vals = mask
                c = segment.column(spec.expr.op)
                if c.nulls is not None and null_handling:
                    mask = mask & ~cols[spec.expr.op]["nulls"]
            else:
                vals, nulls = eval_column(spec.expr, segment, cols)
                if nulls is not None and null_handling:
                    mask = mask & ~nulls
            out.append((vals, mask))
        return out

    def _group_key(cols):
        if len(group_dims) == 1 and group_dims[0].kind == "dict":
            # storage-dtype passthrough: the kernel and scatters read it as is
            return cols[group_dims[0].name]["codes"]
        key = None
        for gd in group_dims:
            code = gd.device_code(cols)
            key = code if key is None else key * gd.cardinality + code
        return key

    def _key_packed(cols):
        """(words, code_bits) when the single dict group key shipped packed
        and the plan runs on the kernel backend; else None."""
        if backend != "cuda" or len(group_dims) != 1:
            return None
        gd = group_dims[0]
        bits = packed_meta.get(gd.name)
        if gd.kind != "dict" or not bits or num_docs % (32 // bits):
            return None
        e = cols.get(gd.name)
        if e is None or "codes_packed" not in e:
            return None
        return (e["codes_packed"], bits)

    if kind == "aggregation":

        def kernel(cols, params, dev):
            cols = _overlay_unpacked(cols)
            tmask, _ = filter_fn(cols, params, dev)
            return [fn.partial(vals, mask) for fn, (vals, mask) in zip(aggs, _agg_inputs(cols, tmask))]

    else:
        vranges = agg_vranges(agg_specs, segment)

        def kernel(cols, params, dev):
            cols = _overlay_unpacked(cols)
            tmask, _ = filter_fn(cols, params, dev)
            key_box: List[torch.Tensor] = []

            def key_fn():
                if not key_box:
                    key_box.append(_group_key(cols))
                return key_box[0]

            return grouped_partials(aggs, _agg_inputs(cols, tmask), tmask, key_fn, num_groups, vranges,
                                    backend=backend, key_packed=_key_packed(cols))

    return SegmentPlan(
        kind=kind,
        fn=planned_fn if planned_fn is not None else kernel,
        params=fc.params,
        needed_columns=needed,
        aggs=aggs,
        group_dims=group_dims,
        num_groups=num_groups,
        index_uses=list(fc.index_uses),
    )
