"""Query IR: expressions, predicates, filter tree, query context.

Copy of pinot_tpu/query/ir.py (host-only) without the window, gap-fill,
subquery and join node types: the single-table slice's parser never builds
them.  QueryContext keeps every field, so fingerprints are the JAX
package's byte for byte.  Reference parity: the Thrift query IR PinotQuery/Expression
(pinot-common/src/thrift/query.thrift:21,57) and pinot-core's QueryContext
(pinot-core/.../core/query/request/context/QueryContext.java) — the engine's
internal representation that the SQL parser produces and the planner consumes.

Re-design: one small immutable tree; hashable/fingerprintable so compiled
plans can be cached by (query shape, segment layout) — the analog of
Pinot's plan cache by query shape.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------
class ExprKind(enum.Enum):
    COLUMN = "COLUMN"
    LITERAL = "LITERAL"
    CALL = "CALL"


@dataclass(frozen=True)
class Expr:
    """Expression node (query.thrift Expression analog).

    kind COLUMN: name in `op`.
    kind LITERAL: python value in `value`.
    kind CALL: function name in `op`, children in `args` (arithmetic,
    transform functions, and aggregation calls share this node type, exactly
    like Pinot's FunctionContext)."""

    kind: ExprKind
    op: str = ""
    value: Any = None
    args: Tuple["Expr", ...] = ()

    # -- constructors ----------------------------------------------------
    @staticmethod
    def col(name: str) -> "Expr":
        return Expr(ExprKind.COLUMN, op=name)

    @staticmethod
    def lit(value: Any) -> "Expr":
        return Expr(ExprKind.LITERAL, value=value)

    @staticmethod
    def call(op: str, *args: "Expr") -> "Expr":
        return Expr(ExprKind.CALL, op=op.lower(), args=tuple(args))

    # -- helpers ---------------------------------------------------------
    @property
    def is_column(self) -> bool:
        return self.kind is ExprKind.COLUMN

    @property
    def is_literal(self) -> bool:
        return self.kind is ExprKind.LITERAL

    def columns(self) -> List[str]:
        if self.kind is ExprKind.COLUMN:
            return [self.op]
        out: List[str] = []
        for a in self.args:
            out.extend(a.columns())
        return out

    def fingerprint(self) -> str:
        if self.kind is ExprKind.COLUMN:
            return f"c:{self.op}"
        if self.kind is ExprKind.LITERAL:
            return f"l:{self.value!r}"
        return f"f:{self.op}({','.join(a.fingerprint() for a in self.args)})"

    def __str__(self) -> str:
        if self.kind is ExprKind.COLUMN:
            return self.op
        if self.kind is ExprKind.LITERAL:
            return repr(self.value)
        return f"{self.op}({', '.join(str(a) for a in self.args)})"


def map_expr_columns(e: "Expr", fn) -> "Expr":
    """Rewrite COLUMN leaves via fn(Expr) -> Expr (identity-preserving)."""
    if e.kind is ExprKind.COLUMN:
        return fn(e)
    if e.kind is ExprKind.CALL:
        new_args = tuple(map_expr_columns(a, fn) for a in e.args)
        if new_args != e.args:
            return Expr(ExprKind.CALL, op=e.op, value=e.value, args=new_args)
    return e


def map_filter_columns(node: Optional["FilterNode"], fn) -> Optional["FilterNode"]:
    import dataclasses as _dc

    if node is None:
        return None
    if node.op is FilterOp.PRED:
        p = node.predicate
        new_lhs = map_expr_columns(p.lhs, fn)
        if new_lhs is not p.lhs:
            return FilterNode.pred(_dc.replace(p, lhs=new_lhs))
        return node
    return FilterNode(
        node.op,
        children=tuple(map_filter_columns(c, fn) for c in node.children),
        predicate=node.predicate,
    )


# ---------------------------------------------------------------------------
# Predicates & filter tree
# ---------------------------------------------------------------------------
class PredicateType(enum.Enum):
    EQ = "EQ"
    NEQ = "NEQ"
    IN = "IN"
    NOT_IN = "NOT_IN"
    RANGE = "RANGE"  # lo/hi with inclusivity flags; half-open forms of >,>=,<,<=,BETWEEN
    REGEXP_LIKE = "REGEXP_LIKE"
    LIKE = "LIKE"
    IS_NULL = "IS_NULL"
    IS_NOT_NULL = "IS_NOT_NULL"
    TEXT_MATCH = "TEXT_MATCH"
    JSON_MATCH = "JSON_MATCH"
    VECTOR_SIMILARITY = "VECTOR_SIMILARITY"


@dataclass(frozen=True)
class Predicate:
    """Leaf predicate over one expression (pinot-core predicate analog:
    .../core/query/request/context/predicate/)."""

    ptype: PredicateType
    lhs: Expr
    # EQ/NEQ: values[0]; IN/NOT_IN: values tuple; REGEXP/LIKE/TEXT/JSON: pattern.
    values: Tuple[Any, ...] = ()
    # RANGE bounds: None = unbounded.
    lower: Any = None
    upper: Any = None
    lower_inclusive: bool = True
    upper_inclusive: bool = True

    def fingerprint(self) -> str:
        return (
            f"{self.ptype.value}:{self.lhs.fingerprint()}:{self.values!r}:"
            f"{self.lower!r}:{self.upper!r}:{self.lower_inclusive}:{self.upper_inclusive}"
        )

    def __str__(self) -> str:
        if self.ptype is PredicateType.RANGE:
            lo = f"{self.lower!r} {'<=' if self.lower_inclusive else '<'} " if self.lower is not None else ""
            hi = f" {'<=' if self.upper_inclusive else '<'} {self.upper!r}" if self.upper is not None else ""
            return f"{lo}{self.lhs}{hi}"
        return f"{self.lhs} {self.ptype.value} {self.values!r}"


class FilterOp(enum.Enum):
    AND = "AND"
    OR = "OR"
    NOT = "NOT"
    PRED = "PRED"


@dataclass(frozen=True)
class FilterNode:
    """Boolean filter tree (FilterContext analog)."""

    op: FilterOp
    children: Tuple["FilterNode", ...] = ()
    predicate: Optional[Predicate] = None

    @staticmethod
    def pred(p: Predicate) -> "FilterNode":
        return FilterNode(FilterOp.PRED, predicate=p)

    @staticmethod
    def and_(*children: "FilterNode") -> "FilterNode":
        return FilterNode(FilterOp.AND, children=tuple(children))

    @staticmethod
    def or_(*children: "FilterNode") -> "FilterNode":
        return FilterNode(FilterOp.OR, children=tuple(children))

    @staticmethod
    def not_(child: "FilterNode") -> "FilterNode":
        return FilterNode(FilterOp.NOT, children=(child,))

    def fingerprint(self) -> str:
        if self.op is FilterOp.PRED:
            return self.predicate.fingerprint()
        return f"{self.op.value}({';'.join(c.fingerprint() for c in self.children)})"

    def predicates(self) -> List[Predicate]:
        if self.op is FilterOp.PRED:
            return [self.predicate]
        out: List[Predicate] = []
        for c in self.children:
            out.extend(c.predicates())
        return out

    def columns(self) -> List[str]:
        out: List[str] = []
        for p in self.predicates():
            out.extend(p.lhs.columns())
        return out


# ---------------------------------------------------------------------------
# Aggregations & query context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AggregationSpec:
    """One aggregation call, optionally filtered (FILTER(WHERE ...) clause —
    Pinot's filtered aggregations, AggregationPlanNode filtered variants)."""

    function: str  # lowercase: count/sum/min/max/avg/distinctcount/...
    expr: Optional[Expr]  # None for COUNT(*)
    filter: Optional[FilterNode] = None
    # extra literal args, e.g. percentile rank, HLL log2m
    literal_args: Tuple[Any, ...] = ()
    # extra EXPRESSION args beyond the first (LASTWITHTIME's time column)
    extra_exprs: Tuple[Expr, ...] = ()

    def fingerprint(self) -> str:
        e = self.expr.fingerprint() if self.expr else "*"
        f = self.filter.fingerprint() if self.filter else ""
        x = "|".join(a.fingerprint() for a in self.extra_exprs)
        return f"{self.function}({e};{x})[{f}]{self.literal_args!r}"

    def __str__(self) -> str:
        return f"{self.function}({self.expr if self.expr else '*'})"


@dataclass(frozen=True)
class OrderByExpr:
    expr: Expr
    ascending: bool = True
    nulls_last: bool = True


@dataclass
class QueryContext:
    """Everything the engine needs for one query (QueryContext.java analog).

    select_list entries are Expr (projection / group column refs) or
    AggregationSpec.  For group-by queries, Pinot requires select expressions
    to be group keys or aggregations — same constraint here."""

    table: str
    select_list: List[Union[Expr, AggregationSpec]]
    select_aliases: List[Optional[str]] = dc_field(default_factory=list)
    table_alias: Optional[str] = None
    # joins / set_ops / gapfill are never set by this slice's parser; they
    # stay so fingerprints match the JAX package's
    joins: List[Any] = dc_field(default_factory=list)
    filter: Optional[FilterNode] = None
    group_by: List[Expr] = dc_field(default_factory=list)
    having: Optional[FilterNode] = None
    order_by: List[OrderByExpr] = dc_field(default_factory=list)
    limit: int = 10
    offset: int = 0
    # SQL `SET key=value` per-query options (QueryOptionsUtils analog):
    # numGroupsLimit, enableNullHandling, timeoutMs, maxExecutionThreads...
    options: Dict[str, Any] = dc_field(default_factory=dict)
    # aggregations referenced ONLY by ORDER BY/HAVING (not selected) — Pinot
    # allows `GROUP BY d ORDER BY SUM(v)` without selecting SUM(v); these are
    # computed alongside select aggregations but excluded from output rows.
    extra_aggregations: List[AggregationSpec] = dc_field(default_factory=list)
    # set operations chained onto this query: (op, all_flag, rhs ctx) with
    # op in {"union", "intersect", "except"} (MSE SetOperator analog)
    set_ops: List[tuple] = dc_field(default_factory=list)
    # time-bucket gap filling applied post-reduce (GapfillProcessor analog)
    gapfill: Optional[Any] = None

    @property
    def aggregations(self) -> List[AggregationSpec]:
        return [s for s in self.select_list if isinstance(s, AggregationSpec)] + list(
            self.extra_aggregations
        )

    @property
    def is_aggregate(self) -> bool:
        return bool(self.aggregations) or bool(self.group_by)

    @property
    def null_handling(self) -> bool:
        # SQL-standard null semantics by default (delta from Pinot, whose
        # legacy default treats stored placeholder values as values; Pinot's
        # modern enableNullHandling=true matches our default).
        return bool(self.options.get("enableNullHandling", True))

    @property
    def num_groups_limit(self) -> int:
        # InstancePlanMakerImplV2 numGroupsLimit analog (safety valve on the
        # number of groups TRACKED; results may be incomplete beyond it).
        return int(self.options.get("numGroupsLimit", 100_000))

    @property
    def max_dense_groups(self) -> int:
        # Key-space bound for the dense group-table kernel; above it the
        # sparse path runs.  Memory knob, distinct from numGroupsLimit.
        return int(self.options.get("maxDenseGroups", 1 << 20))

    def column_names_out(self) -> List[str]:
        out = []
        for i, s in enumerate(self.select_list):
            alias = self.select_aliases[i] if i < len(self.select_aliases) else None
            out.append(alias if alias else str(s))
        return out

    def shape_fingerprint(self, column_info=None) -> str:
        """Literal-canonicalized fingerprint for compile caches: queries
        that differ only in parameterizable predicate literals share one
        key (query/shape.py holds the per-predicate audit).  `column_info`
        is a per-table metadata provider (shape.column_info_from); without
        it every filter literal conservatively stays in the key."""
        from pinot_tpu_torch.query.shape import shape_fingerprint

        return shape_fingerprint(self, column_info)

    def fingerprint(self) -> str:
        parts = [
            self.table,
            "|".join(j.fingerprint() for j in self.joins),
            "|".join(s.fingerprint() for s in self.select_list),
            self.filter.fingerprint() if self.filter else "",
            "|".join(g.fingerprint() for g in self.group_by),
            self.having.fingerprint() if self.having else "",
            "|".join(f"{o.expr.fingerprint()}:{o.ascending}" for o in self.order_by),
            "|".join(a.fingerprint() for a in self.extra_aggregations),
            str(self.limit),
            str(self.offset),
            str(sorted(self.options.items())),
            "|".join(f"{op}:{al}:{c.fingerprint()}" for op, al, c in self.set_ops),
        ]
        return "\x1f".join(parts)
