"""Shape fingerprint: plan-cache keys by query SHAPE, not literal values.

Copy of pinot_tpu/query/shape.py (host-only; the port has no subquery
markers).  In the port the plan cache holds planned Python closures rather
than compiled XLA programs, but the key and its audit are the same, so both
packages key one query the same way.

Reference parity: Pinot caches per-segment plans by query structure and
feeds literals through predicate evaluators at run time.  The planned
closures take predicate state (dict-code bounds, lookup tables, bitmap
words, value arrays) through the params dict, so two queries that differ
only in literals reuse one plan.

`shape_fingerprint(ctx, column_info)` canonicalizes every literal that
provably cannot change the planned closure into a typed slot (`?`), keyed by
an explicit per-predicate audit:

  PARAMETERIZABLE (slot in the key, literal rides params):
    * dict-encoded EQ/RANGE on a sorted column, a range-indexed column, or
      a plain scan column — lo/hi codes or doc ranges are int32 params;
    * dict-encoded NEQ/IN/NOT_IN/REGEXP/LIKE without an inverted index —
      the bool lookup table is cardinality-shaped, value-independent;
    * derived-string predicates (fn(dictcol) = 'x') — same table shape;
    * raw-column EQ/NEQ/RANGE with numeric literals — the literal becomes
      a scalar param (query/filter.py eval_cmp);
    * raw-column IN/NOT_IN over numeric literals — the value array pads to
      a bucketed size class (4/16/64/...) with identity fill, so distinct
      list lengths within a bucket share one compile.

  SHAPE-AFFECTING (literal stays in the key):
    * any predicate resolvable through an INVERTED index: the positive-row
      / negated-row / scan choice (`_INV_MAX_ROWS` thresholds in
      query/filter.py) depends on the literal and bakes `negate`;
    * TEXT_MATCH / JSON_MATCH / VECTOR_SIMILARITY (top-k `k` is traced);
    * values containing non-scalar objects;
    * unknown columns (no metadata — conservative default).

LIMIT/OFFSET and HAVING literals canonicalize unconditionally: both are
applied host-side in reduce from the live ctx.  The audit is deliberately
conservative — a predicate only canonicalizes when every structure decision
the compiler can make for it is literal-independent — and the planner
re-verifies by comparing the rebuilt params structure against the cached
plan before reusing its closure.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

from pinot_tpu_torch.query.ir import (
    FilterNode,
    FilterOp,
    Predicate,
    PredicateType,
    QueryContext,
)

# column metadata the audit needs; `None` from a provider means "unknown"
class ColumnShape(NamedTuple):
    has_dictionary: bool
    is_sorted: bool
    has_inverted: bool
    has_range_index: bool


# provider: column name -> ColumnShape | None
ColumnInfo = Callable[[str], Optional[ColumnShape]]

# IN-list size classes: distinct list lengths within one bucket share a
# compile; the compiler pads the value array to the bucket with identity
# fill (repeating a member never changes isin semantics)
_IN_BUCKETS = (4, 16, 64, 256, 1024, 4096)


def bucket_size(n: int) -> int:
    for b in _IN_BUCKETS:
        if n <= b:
            return b
    return n  # beyond the largest class: exact size keys itself


def column_info_from(table_like: Any) -> ColumnInfo:
    """Best-effort provider over a segment / StackedTable / shard view:
    anything with `.column(name)` and an `.indexes` dict.  Unknown columns
    (or any introspection failure) return None -> the audit bakes."""

    def info(name: str) -> Optional[ColumnShape]:
        try:
            col = table_like.column(name)
        except Exception:
            return None
        if col is None:
            return None
        idx = getattr(table_like, "indexes", None) or {}
        stats = getattr(col, "stats", None)
        return ColumnShape(
            has_dictionary=bool(getattr(col, "has_dictionary", False)),
            is_sorted=bool(getattr(stats, "is_sorted", False))
            and getattr(col, "codes", None) is not None,
            has_inverted=name in (idx.get("inverted") or {}),
            has_range_index=name in (idx.get("range") or {}),
        )

    return info


def _type_class(v: Any) -> Optional[str]:
    """Literal type class — part of the slot (a float param and an int
    param trace different dtypes).  None = not a parameterizable scalar."""
    if v is None:
        return "n"
    if isinstance(v, bool):
        return "b"
    if isinstance(v, int):
        return "i"
    if isinstance(v, float):
        return "f"
    if isinstance(v, str):
        return "s"
    return None


def _scalar_classes(values: Tuple[Any, ...]) -> Optional[List[str]]:
    out: List[str] = []
    for v in values:
        c = _type_class(v)
        if c is None:
            return None
        out.append(c)
    return out


_NUMERIC = ("b", "i", "f")

# predicates routed through _compile_dict_predicate's bool-table path
_TABLE_PREDS = (
    PredicateType.NEQ,
    PredicateType.IN,
    PredicateType.NOT_IN,
    PredicateType.REGEXP_LIKE,
    PredicateType.LIKE,
)


def audit_predicate(p: Predicate, info: Optional[ColumnInfo]) -> Tuple[bool, str]:
    """(parameterizable, reason) for ONE predicate — the explicit
    shape-affecting audit.  `reason` names the deciding rule so EXPLAIN /
    tests can assert on WHY a literal stayed in the key."""
    pt = p.ptype
    if pt in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
        return False, "no-literals"
    if pt in (
        PredicateType.TEXT_MATCH,
        PredicateType.JSON_MATCH,
        PredicateType.VECTOR_SIMILARITY,
    ):
        return False, "traced-structure"
    classes = _scalar_classes(p.values)
    if classes is None:
        return False, "non-scalar-values"
    bound_classes = _scalar_classes(tuple(v for v in (p.lower, p.upper) if v is not None))
    if bound_classes is None:
        return False, "non-scalar-bounds"

    if p.lhs.is_column:
        cs = info(p.lhs.op) if info is not None else None
        if cs is None:
            return False, "unknown-column"
        if cs.has_dictionary:
            if pt in (PredicateType.EQ, PredicateType.RANGE):
                if cs.is_sorted or cs.has_range_index or not cs.has_inverted:
                    return True, "dict-code-range"
                return False, "inverted-index-threshold"
            if pt in _TABLE_PREDS:
                if cs.has_inverted:
                    return False, "inverted-index-threshold"
                return True, "dict-table"
            return False, "unsupported-ptype"
        # raw column: literals become device params — numeric only
        if pt in (PredicateType.EQ, PredicateType.NEQ, PredicateType.RANGE):
            if all(c in _NUMERIC for c in classes + bound_classes):
                return True, "raw-cmp-param"
            return False, "non-numeric-raw"
        if pt in (PredicateType.IN, PredicateType.NOT_IN):
            if classes and all(c in _NUMERIC for c in classes):
                return True, "raw-in-bucketed"
            return False, "non-numeric-raw"
        return False, "unsupported-ptype"

    # CALL lhs: routes to the derived-string table (dict inner column) or
    # the raw value path — both literal-independent in structure, but only
    # numeric literals are provably safe on the raw side, and the derived
    # path handles strings host-side.  EQ/NEQ/RANGE/IN/NOT_IN only; the
    # regex forms raise on the raw path, so their routing IS the structure.
    if pt in (PredicateType.EQ, PredicateType.NEQ, PredicateType.RANGE):
        if all(c in _NUMERIC for c in classes + bound_classes):
            return True, "call-cmp-param"
        return False, "non-numeric-call"
    if pt in (PredicateType.IN, PredicateType.NOT_IN):
        if classes and all(c in _NUMERIC for c in classes):
            return True, "call-in-bucketed"
        return False, "non-numeric-call"
    return False, "unsupported-ptype"


def _slot(p: Predicate) -> str:
    """Canonical literal-free form of a parameterizable predicate: type
    classes + bucket size + bound presence/inclusivity — everything that
    still selects a distinct traced program, nothing that doesn't."""
    classes = _scalar_classes(p.values) or []
    if p.ptype in (PredicateType.IN, PredicateType.NOT_IN):
        tclass = classes[0] if classes else "?"
        return f"?set[{tclass}x{bucket_size(len(p.values))}]"
    if p.ptype is PredicateType.RANGE:
        lo = "" if p.lower is None else (_type_class(p.lower) or "?")
        hi = "" if p.upper is None else (_type_class(p.upper) or "?")
        li = "[" if p.lower_inclusive else "("
        ui = "]" if p.upper_inclusive else ")"
        return f"?{li}{lo},{hi}{ui}"
    return f"?{','.join(classes)}"


def predicate_shape_fp(p: Predicate, info: Optional[ColumnInfo]) -> str:
    ok, _reason = audit_predicate(p, info)
    if not ok:
        return p.fingerprint()
    return f"{p.ptype.value}:{p.lhs.fingerprint()}:{_slot(p)}"


def _filter_shape_fp(node: Optional[FilterNode], info: Optional[ColumnInfo]) -> str:
    if node is None:
        return ""
    if node.op is FilterOp.PRED:
        return predicate_shape_fp(node.predicate, info)
    return f"{node.op.value}({';'.join(_filter_shape_fp(c, info) for c in node.children)})"


def _host_info(_name: str) -> ColumnShape:
    """Permissive provider for host-evaluated trees (HAVING runs in reduce
    from the live ctx; nothing it holds is ever traced)."""
    return ColumnShape(True, False, False, False)


def _canon_option(v: Any) -> Any:
    """Option values canonicalized for the shape key: ndarray payloads
    (sketch-binding __dictvals__) reduce to shape+dtype — the companion
    __dictfp__ already identifies the content."""
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        return f"ndarray{tuple(shape)}:{dtype}"
    return v


def params_structure(params: Any) -> Tuple:
    """Structural signature of a params pytree: sorted (key, dtype, shape)
    per leaf, nested dicts recursed.  Two param dicts with equal structure
    replay one traced program; the engines compare a shape-cache hit's
    rebuilt params against the cached plan's before reusing its compiled
    fn — the safety net under the audit."""
    import numpy as np

    out: List[Tuple] = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.append((k, params_structure(v)))
        else:
            arr = np.asarray(v)
            out.append((k, str(arr.dtype), tuple(arr.shape)))
    return tuple(out)


def shape_fingerprint(ctx: QueryContext, column_info: Optional[ColumnInfo] = None) -> str:
    """Literal-canonicalized twin of QueryContext.fingerprint().  Queries
    with equal shape fingerprints (against equal segment signatures and
    backend) trace the same program; literals ride the params pytree.  The
    `trace` option is excluded (spans are host-side), and LIMIT/OFFSET
    canonicalize to slots (applied host-side in reduce)."""
    opts = sorted(
        (k, _canon_option(v)) for k, v in ctx.options.items() if k != "trace"
    )
    parts = [
        "shape1",  # versioned prefix: never collides with full fingerprints
        ctx.table,
        "|".join(j.fingerprint() for j in ctx.joins),
        "|".join(s.fingerprint() for s in ctx.select_list),
        _filter_shape_fp(ctx.filter, column_info),
        "|".join(g.fingerprint() for g in ctx.group_by),
        _filter_shape_fp(ctx.having, _host_info),
        "|".join(f"{o.expr.fingerprint()}:{o.ascending}" for o in ctx.order_by),
        "|".join(a.fingerprint() for a in ctx.extra_aggregations),
        "?limit" if ctx.limit is not None else "",
        "?offset",
        str(opts),
        "|".join(f"{op}:{al}:{c.fingerprint()}" for op, al, c in ctx.set_ops),
    ]
    return "\x1f".join(parts)


def shape_digest(fingerprint: str) -> str:
    """Short stable digest of a shape fingerprint (the perf ledger's key;
    full fingerprints can embed literal values, the digest never does more
    than identify)."""
    return hashlib.sha1(fingerprint.encode("utf-8", "replace")).hexdigest()[:12]
