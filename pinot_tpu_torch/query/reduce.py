"""Broker reduce: merge per-segment results, HAVING/ORDER BY/LIMIT, format.

Trimmed copy of pinot_tpu/query/reduce.py (host-only numpy): the
aggregation and group-by reducers with HAVING, ORDER BY, LIMIT and
post-aggregation arithmetic.  Selection, window and gap-fill reduce come
with their slices.  Reference parity: BrokerReduceService.reduceOnDataTable
(pinot-core/.../query/reduce/BrokerReduceService.java:65) and its per-shape
reducers (GroupByDataTableReducer, AggregationDataTableReducer,
SelectionDataTableReducer) + PostAggregationHandler/HAVING handling.

Re-design: partials arrive as numpy arrays, not serialized DataTables.  The
group-by merge has two paths:
  * ALIGNED DENSE: when every segment produced a dense group table over the
    SAME key space (shared dictionary fingerprints), merging is pure
    elementwise array combination.
  * GENERIC: decoded-key hash merge (GroupByDataTableReducer's IndexedTable
    analog) for heterogeneous segments.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.query.functions import FIELD_COMBINE, combine_field, field_identity, for_spec
from pinot_tpu_torch.query.ir import (
    AggregationSpec,
    Expr,
    FilterNode,
    FilterOp,
    OrderByExpr,
    PredicateType,
    QueryContext,
)
from pinot_tpu_torch.query.result import (
    AggSegmentResult,
    ExecutionStats,
    GroupBySegmentResult,
    ResultTable,
)


def reduce_results(ctx: QueryContext, results: List[Any], stats: ExecutionStats) -> ResultTable:
    if ctx.group_by:
        return _reduce_groupby(ctx, results, stats)
    return _reduce_aggregation(ctx, results, stats)


# ---------------------------------------------------------------------------
# Aggregation-only
# ---------------------------------------------------------------------------
def _reduce_aggregation(ctx: QueryContext, results: List[AggSegmentResult], stats: ExecutionStats) -> ResultTable:
    aggs = [for_spec(a) for a in ctx.aggregations]
    merged: Optional[List[Dict[str, np.ndarray]]] = None
    for r in results:
        if merged is None:
            merged = [dict(p) for p in r.partials]
        else:
            merged = [fn.merge(m, p) for fn, m, p in zip(aggs, merged, r.partials)]
    # finals for every aggregation (selected + hidden extras), then resolve
    # select items — post-aggregation arithmetic evaluates over the env
    specs = list(ctx.aggregations)
    env: Dict[str, Any] = {}
    for i, (spec, fn) in enumerate(zip(specs, aggs)):
        if merged is None:
            val = 0 if fn.name == "count" else None  # all segments pruned
        else:
            val = fn.final(merged[i])
            if not isinstance(val, (list, tuple)):
                val = _scalar(val)
        cell = np.empty(1, dtype=object)  # explicit: np.asarray would
        cell[0] = np.nan if val is None else val  # 2D-ify a list value
        _register_agg_env(env, spec, cell)
    row = []
    for s in ctx.select_list:
        if isinstance(s, AggregationSpec):
            v = env[s.fingerprint()][0]
        else:
            v = _eval_env_expr(s, env, 1)[0]
        row.append(_scalar(v) if not isinstance(v, (str, bytes, list, tuple, type(None))) else v)
    return ResultTable(columns=ctx.column_names_out(), rows=[tuple(row)], stats=stats)


def _scalar(v):
    v = np.asarray(v)
    x = v.item() if v.ndim == 0 else v
    if isinstance(x, float) and (math.isnan(x) or math.isinf(x)):
        return None
    return x


def _register_agg_env(env: Dict[str, Any], spec: AggregationSpec, finals) -> None:
    """Register one aggregation's final array under every fingerprint form
    HAVING/ORDER BY/post-aggregation may reference it by: the spec itself,
    the plain call `sum(v)` (literal args re-attached), and explicit
    `count(*)`.  Shared by the scalar and group-by reducers."""
    env[spec.fingerprint()] = finals
    if spec.filter is None:
        args = list(spec.expr and [spec.expr] or []) + [Expr.lit(a) for a in spec.literal_args]
        env.setdefault(Expr.call(spec.function, *args).fingerprint(), finals)
        if spec.expr is None and not spec.literal_args:
            env.setdefault(Expr.call(spec.function, Expr.col("*")).fingerprint(), finals)


# ---------------------------------------------------------------------------
# Group-by
# ---------------------------------------------------------------------------
def _reduce_groupby(ctx: QueryContext, results: List[GroupBySegmentResult], stats: ExecutionStats) -> ResultTable:
    aggs = [for_spec(a) for a in ctx.aggregations]
    results = [r for r in results if r is not None]
    if not results:
        return ResultTable(columns=ctx.column_names_out(), rows=[], stats=stats)

    # -- aligned dense fast path ---------------------------------------
    key_spaces = {r.dense.key_space for r in results if r.dense is not None}
    if len(results) > 1 and len(key_spaces) == 1 and all(r.dense is not None for r in results):
        d0 = results[0].dense
        presence = np.zeros_like(d0.presence)
        merged_partials = [
            {f: np.full_like(arr, _ident_like(f, arr)) for f, arr in p.items()}
            for p in d0.partials
        ]
        for r in results:
            presence = presence + r.dense.presence
            for ai, p in enumerate(r.dense.partials):
                mp = merged_partials[ai]
                for f in mp:
                    mp[f] = combine_field(f, mp[f], np.asarray(p[f]))
        present = np.nonzero(presence > 0)[0]
        keys = _decode_dense_keys(d0.group_dims, present)
        partials = [{f: arr[present] for f, arr in p.items()} for p in merged_partials]
    elif len(results) == 1:
        keys, partials = results[0].keys, results[0].partials
    else:
        keys, partials = _hash_merge(results, aggs)

    stats.num_groups = len(keys[0]) if keys else 0
    finals = [np.atleast_1d(np.asarray(fn.final(p))) for fn, p in zip(aggs, partials)]

    # fingerprint -> column array, for select/having/order resolution
    env: Dict[str, np.ndarray] = {}
    for g, k in zip(ctx.group_by, keys):
        env[g.fingerprint()] = k
    for spec, f in zip(ctx.aggregations, finals):
        _register_agg_env(env, spec, f)
    # select aliases: ORDER BY/HAVING may reference any select item by alias
    # (covers filtered/literal-arg aggregations the call forms above can't)
    for s, alias in zip(ctx.select_list, ctx.select_aliases):
        if alias:
            fp = s.fingerprint()
            if fp in env:
                env.setdefault(Expr.col(alias).fingerprint(), env[fp])

    # HAVING
    n = len(keys[0]) if keys else 0
    if ctx.having is not None and n:
        mask = _eval_host_filter(ctx.having, env, n)
        keys = [k[mask] for k in keys]
        finals = [f[mask] for f in finals]
        env = {k: v[mask] for k, v in env.items()}
        n = int(mask.sum())

    # output columns in select order (post-aggregation arithmetic resolves
    # against the env of final arrays)
    out_cols: List[np.ndarray] = []
    for s in ctx.select_list:
        out_cols.append(_eval_env_expr(s, env, n) if isinstance(s, Expr) else env[s.fingerprint()])

    rows = _rows_from_columns(out_cols, n)
    rows = _order_and_trim(ctx, rows, [s.fingerprint() for s in ctx.select_list], env, n)
    return ResultTable(columns=ctx.column_names_out(), rows=rows, stats=stats)


def _ident_like(field: str, arr: np.ndarray):
    if field == "count":
        return 0
    ident = field_identity(field)
    if np.issubdtype(np.asarray(arr).dtype, np.integer):
        # +-inf identities don't exist for int fields (presence bitmaps, HLL
        # registers, histograms); use the dtype extremes / zero instead
        info = np.iinfo(np.asarray(arr).dtype)
        return {0.0: 0, float("inf"): info.max, float("-inf"): 0}[ident]
    return ident


def _decode_dense_keys(group_dims, present: np.ndarray) -> List[np.ndarray]:
    from pinot_tpu_torch.query.planner import decode_packed_keys

    return decode_packed_keys(group_dims, present)


def _hash_merge(results: List[GroupBySegmentResult], aggs) -> Tuple[List[np.ndarray], List[Dict[str, np.ndarray]]]:
    """Generic keyed merge (IndexedTable upsert analog).

    Fast path: key tuples encode to dense int codes (np.unique per dim) and
    every partial field combines with ONE ufunc scatter (the FIELD_COMBINE
    name contract) — no per-row Python upsert.  First-seen key order is
    preserved.  Incomparable mixed-type keys fall back to the loop."""
    merged = _hash_merge_vectorized(results, aggs)
    if merged is not None:
        return merged
    table: Dict[tuple, List[Dict[str, Any]]] = {}
    for r in results:
        n = len(r.keys[0]) if r.keys else 0
        for i in range(n):
            key = tuple(k[i] for k in r.keys)
            partial = [{f: arr[i] for f, arr in p.items()} for p in r.partials]
            cur = table.get(key)
            if cur is None:
                table[key] = partial
            else:
                table[key] = [fn.merge(a, b) for fn, a, b in zip(aggs, cur, partial)]
    keys_out: List[np.ndarray] = []
    ndims = len(results[0].keys)
    all_keys = list(table.keys())
    for d in range(ndims):
        keys_out.append(np.asarray([k[d] for k in all_keys], dtype=object))
    partials_out: List[Dict[str, np.ndarray]] = []
    for ai, fn in enumerate(aggs):
        fields = results[0].partials[ai].keys()
        partials_out.append({f: np.asarray([table[k][ai][f] for k in all_keys]) for f in fields})
    return keys_out, partials_out


def _scatter_init(shape, dtype, op: str):
    """Identity-filled accumulator for one ufunc-scatter combine; every group
    has at least one row, so the identity never reaches the output."""
    if op == "add":
        return np.zeros(shape, dtype=dtype)
    if np.issubdtype(dtype, np.floating):
        fill = np.inf if op == "min" else -np.inf
    elif dtype == np.bool_:
        fill = op == "min"
    else:
        info = np.iinfo(dtype)
        fill = info.max if op == "min" else info.min
    return np.full(shape, fill, dtype=dtype)


def _hash_merge_vectorized(results: List[GroupBySegmentResult], aggs):
    """Returns (keys, partials) in first-seen key order, or None when the
    keys defy np.unique coding (caller falls back to the upsert loop)."""
    ndims = len(results[0].keys)
    total = sum(len(r.keys[0]) if r.keys else 0 for r in results)
    if total == 0 or ndims == 0:
        return None
    cat_keys = [
        np.concatenate([np.asarray(r.keys[d], dtype=object) for r in results])
        for d in range(ndims)
    ]
    cards, invs = [], []
    for d in range(ndims):
        try:
            uniq, inv = np.unique(cat_keys[d], return_inverse=True)
        except TypeError:
            return None
        cards.append(max(1, len(uniq)))
        invs.append(inv.reshape(-1))
    space = 1
    for c in cards:
        space *= c
    if space >= (1 << 62):  # packed composite code must fit int64
        return None
    codes = np.zeros(total, dtype=np.int64)
    for card, inv in zip(cards, invs):
        codes = codes * np.int64(card) + inv.astype(np.int64)
    uniq_codes, first_pos, inv = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first_pos, kind="stable")  # sorted-unique -> first-seen
    rank = np.empty(len(uniq_codes), dtype=np.int64)
    rank[order] = np.arange(len(uniq_codes))
    g = rank[inv.reshape(-1)]  # row -> output slot
    k = len(uniq_codes)
    keys_out = [cat_keys[d][first_pos[order]] for d in range(ndims)]
    partials_out: List[Dict[str, np.ndarray]] = []
    for ai in range(len(aggs)):
        out: Dict[str, np.ndarray] = {}
        for f in results[0].partials[ai]:
            arr = np.concatenate(
                [np.atleast_1d(np.asarray(r.partials[ai][f])) for r in results]
            )
            if arr.dtype == object:
                return None  # non-numeric partials: upsert loop path
            op = FIELD_COMBINE[f]
            acc = _scatter_init((k,) + arr.shape[1:], arr.dtype, op)
            if op == "add":
                np.add.at(acc, g, arr)
            elif op == "min":
                np.minimum.at(acc, g, arr)
            else:
                np.maximum.at(acc, g, arr)
            out[f] = acc
        partials_out.append(out)
    return keys_out, partials_out


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------
def _rows_from_columns(cols: Sequence[np.ndarray], n: int) -> List[tuple]:
    rows = []
    for i in range(n):
        rows.append(
            tuple(
                _scalar(c[i]) if not isinstance(c[i], (str, bytes, list, tuple, type(None))) else c[i]
                for c in cols
            )
        )
    return rows


def _order_codes(order_by: List[OrderByExpr], ord_vals: List[np.ndarray], n: int):
    """Vectorized rank keys for _sorted_order's lexsort fast path: each
    column codes to float ranks via np.unique over the RAW objects (python
    `<` ordering, so strings and numbers alike match the comparator), nulls
    to +-inf per nulls placement.  Returns None when a column defies
    total-order coding (mixed incomparable types, NaN) — the caller falls
    back to the Python comparator."""
    keys = []
    for ob, vals in zip(reversed(order_by), reversed(ord_vals)):
        a = np.asarray(vals, dtype=object)
        isnull = np.fromiter((v is None for v in a), dtype=bool, count=len(a))
        body = a[~isnull]
        k = np.empty(n, dtype=np.float64)
        if body.size:
            if any(isinstance(v, (float, np.floating)) and math.isnan(v) for v in body):
                return None
            try:
                _, inv = np.unique(body, return_inverse=True)
            except TypeError:
                return None
            num = inv.reshape(-1).astype(np.float64)
            k[~isnull] = num if ob.ascending else -num
        k[isnull] = np.inf if ob.nulls_last else -np.inf
        keys.append(k)
    return keys


def _sorted_order(order_by: List[OrderByExpr], ord_vals: List[np.ndarray], n: int) -> List[int]:
    """Stable index sort honoring asc/desc + nulls placement, robust to
    mixed/None/object values (python comparison semantics)."""
    if n > 1:
        keys = _order_codes(order_by, ord_vals, n)
        if keys is not None:
            # np.lexsort is stable, so equal-ranked rows keep their original
            # order — the same i - j tiebreak the comparator applies
            return list(np.lexsort(tuple(keys)))

    def cmp(i: int, j: int) -> int:
        for ob, vals in zip(order_by, ord_vals):
            a, b = vals[i], vals[j]
            if a is None or b is None:
                if a is None and b is None:
                    continue
                null_first = not ob.nulls_last
                if a is None:
                    return -1 if null_first else 1
                return 1 if null_first else -1
            if a == b:
                continue
            less = a < b
            if ob.ascending:
                return -1 if less else 1
            return 1 if less else -1
        return i - j  # stable tiebreak

    return sorted(range(n), key=functools.cmp_to_key(cmp))


def _order_and_trim(
    ctx: QueryContext,
    rows: List[tuple],
    select_fps: List[str],
    env: Dict[str, np.ndarray],
    n: int,
) -> List[tuple]:
    if ctx.order_by:
        ord_vals = []
        for ob in ctx.order_by:
            try:
                vals = _eval_env_expr(ob.expr, env, n)
            except ValueError:
                raise ValueError(
                    f"ORDER BY {ob.expr} must be a select/group/aggregation expression"
                ) from None
            ord_vals.append(np.asarray([_scalar(v) if not isinstance(v, (str, bytes, type(None))) else v for v in vals], dtype=object))
        order = _sorted_order(ctx.order_by, ord_vals, n)
        rows = [rows[i] for i in order]
    return rows[ctx.offset: ctx.offset + ctx.limit]


_ENV_BINOPS = {
    "plus": np.add,
    "add": np.add,
    "minus": np.subtract,
    "sub": np.subtract,
    "times": np.multiply,
    "mult": np.multiply,
    "mod": np.mod,
    "pow": np.power,
}
_ENV_UNARY = {
    "abs": np.abs,
    "neg": np.negative,
    "sqrt": np.sqrt,
    "ln": np.log,
    "log": np.log,
    "log2": np.log2,
    "log10": np.log10,
    "exp": np.exp,
    "floor": np.floor,
    "ceil": np.ceil,
    "ceiling": np.ceil,
    "round": np.round,
}


def _eval_env_expr(e, env: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """POST-AGGREGATION expression evaluation over final arrays — the
    reference's post-aggregation gap-filling (PostAggregationFunction):
    SELECT SUM(a)/COUNT(*), HAVING SUM(v)*2 > x, ORDER BY SUM(a)-SUM(b).
    Resolution: fingerprint in env (group keys, aggregation finals, aliases)
    else arithmetic over recursively evaluated args."""
    fp = e.fingerprint()
    if fp in env:
        return np.asarray(env[fp])
    if e.is_literal:
        return np.full(n, e.value)
    if e.kind is not None and e.kind.name == "CALL":
        op = e.op
        if op in _ENV_BINOPS and len(e.args) == 2:
            a = np.asarray(_eval_env_expr(e.args[0], env, n), dtype=np.float64)
            b = np.asarray(_eval_env_expr(e.args[1], env, n), dtype=np.float64)
            return _ENV_BINOPS[op](a, b)
        if op in ("divide", "div") and len(e.args) == 2:
            a = np.asarray(_eval_env_expr(e.args[0], env, n), dtype=np.float64)
            b = np.asarray(_eval_env_expr(e.args[1], env, n), dtype=np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                return a / b
        if op in _ENV_UNARY and len(e.args) == 1:
            return _ENV_UNARY[op](np.asarray(_eval_env_expr(e.args[0], env, n), dtype=np.float64))
    raise ValueError(f"select item {e} is neither a group key nor an aggregation")


def _eval_host_filter(node: FilterNode, env: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """HAVING evaluation over final (already-aggregated) columns."""
    if node.op is FilterOp.AND:
        m = np.ones(n, dtype=bool)
        for c in node.children:
            m &= _eval_host_filter(c, env, n)
        return m
    if node.op is FilterOp.OR:
        m = np.zeros(n, dtype=bool)
        for c in node.children:
            m |= _eval_host_filter(c, env, n)
        return m
    if node.op is FilterOp.NOT:
        return ~_eval_host_filter(node.children[0], env, n)
    p = node.predicate
    try:
        vals = _eval_env_expr(p.lhs, env, n)
    except ValueError:
        raise ValueError(f"HAVING references {p.lhs}, which is not in the select/group list") from None

    def isnull(v) -> bool:
        # NULL aggregates arrive as np.nan here (converted to None only at
        # _scalar); SQL 3VL: any comparison with NULL excludes the group.
        return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))

    if p.ptype is PredicateType.EQ:
        return np.asarray([not isnull(v) and v == p.values[0] for v in vals], dtype=bool)
    if p.ptype is PredicateType.NEQ:
        return np.asarray([not isnull(v) and v != p.values[0] for v in vals], dtype=bool)
    if p.ptype in (PredicateType.IN, PredicateType.NOT_IN):
        s = set(p.values)
        if p.ptype is PredicateType.IN:
            return np.asarray([not isnull(v) and v in s for v in vals], dtype=bool)
        return np.asarray([not isnull(v) and v not in s for v in vals], dtype=bool)
    if p.ptype is PredicateType.RANGE:
        m = np.ones(n, dtype=bool)
        for i, v in enumerate(vals):
            if isnull(v):
                m[i] = False
                continue
            if p.lower is not None and not (v >= p.lower if p.lower_inclusive else v > p.lower):
                m[i] = False
            if p.upper is not None and not (v <= p.upper if p.upper_inclusive else v < p.upper):
                m[i] = False
        return m
    raise ValueError(f"HAVING predicate {p.ptype} unsupported")
