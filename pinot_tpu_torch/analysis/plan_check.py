"""Plan-time static type/shape checker over the query IR.

Copy of pinot_tpu/analysis/plan_check.py (host-only), reading the port's
own function registries.  It walks Expr/Filter/QueryContext trees
(query/ir.py) and validates — before the planner builds a closure or
anything launches — the invariants whose violation otherwise surfaces as
an error deep inside planning, or worse, as silently-wrong results under
int32 wrapping.  Issues and messages are the JAX package's, word for word:

  * function existence + arity against the transform/scalar/aggregation
    registries (query/transform.py, query/scalar.py, query/functions.py)
  * aggregation nesting (no agg inside an agg argument, GROUP BY or WHERE)
  * group-by key groupability (no literal keys)
  * predicate/column dtype compatibility, including int32-overflow and
    weak-type float promotion hazards against integer columns
  * LIMIT/OFFSET and aggregate ORDER BY sanity

Violations raise PlanCheckError (a ValueError) carrying a stable machine
code (the JAX package's REST layer maps it to a structured 400 response).  Checks are
deliberately conservative: only statically CERTAIN errors are flagged, so
every plan the executors accept today still passes.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.query.ir import (
    AggregationSpec,
    Expr,
    ExprKind,
    FilterNode,
    FilterOp,
    Predicate,
    PredicateType,
    QueryContext,
    WindowSpec,
)

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1

# boolean/structural ops the parser emits inside CASE conditions and the
# funnel STEPS(...) form, plus engine-special select ops (UNNEST explodes in
# the executor, not the transform registry) — arity is validated elsewhere
_STRUCTURAL_OPS = frozenset(
    {"case", "steps", "unnest", "__and", "__or", "__not", "__eq", "__in", "__ge", "__gt", "__le", "__lt", "__isnull"}
)
_WINDOW_FNS = frozenset(
    {
        "row_number", "rank", "dense_rank", "ntile", "lag", "lead", "first_value",
        "last_value", "sum", "count", "avg", "min", "max", "bool_and", "bool_or",
    }
)


class PlanCheckError(ValueError):
    """One statically-detected plan defect, with a stable machine code."""

    def __init__(self, code: str, message: str, where: str = "query"):
        super().__init__(f"[{code}] {message} (in {where})")
        self.code = code
        self.detail = message
        self.where = where

    def to_dict(self) -> Dict[str, Any]:
        return {"errorCode": self.code, "error": self.detail, "where": self.where}


@dataclass(frozen=True)
class PlanIssue:
    code: str
    message: str
    where: str

    def to_error(self) -> PlanCheckError:
        return PlanCheckError(self.code, self.message, self.where)


# ---------------------------------------------------------------------------
# registry views (lazy: planner imports this module, transform imports scalar)
# ---------------------------------------------------------------------------
def _registries():
    from pinot_tpu_torch.query import functions, scalar, transform

    return {
        "binary": set(transform._BINARY) | {"divide", "div"},
        "unary": set(transform._UNARY),
        "device": set(scalar.DEVICE_FNS),
        "device_multi": dict(scalar.DEVICE_MULTI_FNS),
        "dict": set(scalar.DICT_FNS),
        "agg": set(functions._REGISTRY),
    }


def _multi_fn_arity(fn) -> Tuple[int, Optional[int]]:
    """(min, max) positional arity of a DEVICE_MULTI_FNS entry; max=None for
    *args forms."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return 0, None
    lo = hi = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            hi += 1
            if p.default is p.empty:
                lo += 1
        elif p.kind is p.VAR_POSITIONAL:
            return lo, None
    return lo, hi


# ---------------------------------------------------------------------------
# expression walker
# ---------------------------------------------------------------------------
class _Checker:
    def __init__(self, ctx: QueryContext, schema=None):
        self.ctx = ctx
        self.schema = schema
        self.reg = _registries()
        self.issues: List[PlanIssue] = []
        self.aliases: Set[str] = {a for a in (ctx.select_aliases or []) if a}

    def issue(self, code: str, message: str, where: str) -> None:
        self.issues.append(PlanIssue(code, message, where))

    # -- columns ---------------------------------------------------------
    def check_column(self, name: str, where: str) -> None:
        if self.schema is None or name == "*" or name in self.aliases:
            return
        # internal/virtual names ($docId-style, join facades 'alias$col',
        # engine-injected '__'-prefixed helpers) bypass schema resolution
        if name.startswith(("$", "__")) or "$" in name or "." in name:
            return
        if name not in self.schema:
            self.issue(
                "UNKNOWN_COLUMN",
                f"column {name!r} is not in schema {self.schema.name!r}",
                where,
            )

    def _field(self, name: str):
        if self.schema is not None and name in self.schema:
            return self.schema.field(name)
        return None

    # -- expressions -----------------------------------------------------
    def check_expr(self, e: Optional[Expr], where: str, in_agg: bool = False, agg_ok: bool = True) -> None:
        """agg_ok: aggregation-named calls are legal here (select/order/having
        items resolve against reduced aggregation finals); in_agg: we are
        inside an aggregation argument, where a further agg call is nesting."""
        if e is None:
            return
        if e.kind is ExprKind.COLUMN:
            self.check_column(e.op, where)
            return
        if e.kind is ExprKind.LITERAL:
            return
        op = e.op
        reg = self.reg
        is_agg_name = op in reg["agg"]
        is_scalar_name = (
            op in reg["binary"] or op in reg["unary"] or op in reg["device"]
            or op in reg["device_multi"] or op in reg["dict"] or op in _STRUCTURAL_OPS
            or op in ("cast", "arraylength", "cardinality", "least", "greatest", "todatetime")
        )
        if is_agg_name and not is_scalar_name:
            if in_agg:
                self.issue(
                    "NESTED_AGGREGATION",
                    f"aggregation {op!r} cannot be nested inside another aggregation's arguments",
                    where,
                )
                return
            if not agg_ok:
                self.issue(
                    "NESTED_AGGREGATION",
                    f"aggregation {op!r} is not allowed here (WHERE / GROUP BY run before aggregation)",
                    where,
                )
                return
            # select/order/having position: the call resolves against a
            # reduced aggregation final; its argument is that agg's input
            for a in e.args:
                self.check_expr(a, where, in_agg=True, agg_ok=False)
            return
        # scalar calls pass agg-tolerance through: SUM(x)/COUNT(x) in a
        # select/order/having position is arithmetic over reduced finals
        child_agg_ok = agg_ok and not in_agg
        if not is_scalar_name:
            self.issue("UNKNOWN_FUNCTION", f"unknown function {op!r}", where)
            # still walk args: one bad call should not mask a second defect
            for a in e.args:
                self.check_expr(a, where, in_agg=in_agg, agg_ok=child_agg_ok)
            return
        self._check_arity(e, where)
        for a in e.args:
            self.check_expr(a, where, in_agg=in_agg, agg_ok=child_agg_ok)

    def _check_arity(self, e: Expr, where: str) -> None:
        op, n = e.op, len(e.args)
        reg = self.reg
        if op in reg["binary"] and n != 2:
            self.issue("BAD_ARITY", f"{op}() takes exactly 2 arguments, got {n}", where)
        elif op in reg["unary"] and n != 1:
            self.issue("BAD_ARITY", f"{op}() takes exactly 1 argument, got {n}", where)
        elif op == "cast" and (n != 2 or not e.args[1].is_literal):
            self.issue("BAD_ARITY", "cast() takes (expression, type-literal)", where)
        elif op in ("arraylength", "cardinality") and n != 1:
            self.issue("BAD_ARITY", f"{op}() takes exactly 1 argument, got {n}", where)
        elif op in ("least", "greatest") and n < 1:
            self.issue("BAD_ARITY", f"{op}() needs at least 1 argument", where)
        elif op in reg["device_multi"]:
            lo, hi = _multi_fn_arity(reg["device_multi"][op])
            if n < lo or (hi is not None and n > hi):
                want = f"{lo}" if hi == lo else f"{lo}..{'*' if hi is None else hi}"
                self.issue("BAD_ARITY", f"{op}() takes {want} arguments, got {n}", where)
        elif op in reg["device"] or op in reg["dict"]:
            # one traced operand + literal parameters (transform.py contract)
            traced = [a for a in e.args if not a.is_literal]
            if len(traced) != 1:
                self.issue(
                    "BAD_ARITY",
                    f"{op}() expects exactly one column/expression argument, got {len(traced)}",
                    where,
                )

    # -- filters ---------------------------------------------------------
    def check_filter(self, node: Optional[FilterNode], where: str, agg_ok: bool = False) -> None:
        if node is None:
            return
        if node.op is FilterOp.PRED and node.predicate is not None:
            self.check_predicate(node.predicate, where, agg_ok=agg_ok)
            return
        for c in node.children:
            self.check_filter(c, where, agg_ok=agg_ok)

    def check_predicate(self, p: Predicate, where: str, agg_ok: bool = False) -> None:
        self.check_expr(p.lhs, where, agg_ok=agg_ok)
        if not p.lhs.is_column:
            return
        f = self._field(p.lhs.op)
        if f is None:
            return
        dt = f.data_type
        values: List[Any] = []
        if p.ptype in (PredicateType.EQ, PredicateType.NEQ, PredicateType.IN, PredicateType.NOT_IN):
            values = list(p.values)
        elif p.ptype is PredicateType.RANGE:
            values = [v for v in (p.lower, p.upper) if v is not None]
        if dt.is_numeric and not dt.name == "BOOLEAN":
            for v in values:
                if isinstance(v, str):
                    try:
                        float(v)
                    except (TypeError, ValueError):
                        self.issue(
                            "TYPE_MISMATCH",
                            f"non-numeric literal {v!r} compared against {dt.name} column {p.lhs.op!r}",
                            where,
                        )
                elif isinstance(v, bool):
                    continue
                elif isinstance(v, int) and dt.name == "INT" and not _INT32_MIN <= v <= _INT32_MAX:
                    self.issue(
                        "INT32_OVERFLOW",
                        f"literal {v} overflows INT column {p.lhs.op!r} (int32 wraps under TPU x32)",
                        where,
                    )
                elif (
                    isinstance(v, float)
                    and dt.name in ("INT", "LONG", "TIMESTAMP")
                    and v != int(v)
                    and p.ptype in (PredicateType.EQ, PredicateType.IN)
                ):
                    self.issue(
                        "WEAK_TYPE_PROMOTION",
                        f"equality on {dt.name} column {p.lhs.op!r} against non-integral float "
                        f"{v!r} can never match (weak f32 promotion hazard in kernels)",
                        where,
                    )
        if p.ptype in (PredicateType.REGEXP_LIKE, PredicateType.LIKE, PredicateType.TEXT_MATCH) and not dt.is_string_like:
            self.issue(
                "TYPE_MISMATCH",
                f"{p.ptype.value} requires a string-like column, {p.lhs.op!r} is {dt.name}",
                where,
            )

    # -- aggregations ----------------------------------------------------
    def check_aggregation(self, spec: AggregationSpec, where: str) -> None:
        from pinot_tpu_torch.query import functions

        if spec.function not in self.reg["agg"]:
            self.issue("UNKNOWN_AGGREGATION", f"unknown aggregation function {spec.function!r}", where)
            return
        try:
            fn = functions.for_spec(spec)
        except (ValueError, TypeError) as exc:
            self.issue("BAD_ARITY", f"{spec.function}: {exc}", where)
            fn = None
        if fn is not None and getattr(fn, "needs_expr", True) and spec.expr is None:
            self.issue("BAD_ARITY", f"{spec.function}() requires an argument expression", where)
        self.check_expr(spec.expr, where, in_agg=True, agg_ok=False)
        for ex in spec.extra_exprs:
            self.check_expr(ex, where, in_agg=True, agg_ok=False)
        self.check_filter(spec.filter, f"{where} FILTER", agg_ok=False)

    def check_window(self, spec: WindowSpec, where: str) -> None:
        if spec.function not in _WINDOW_FNS:
            self.issue("UNKNOWN_FUNCTION", f"unknown window function {spec.function!r}", where)
        self.check_expr(spec.expr, where, in_agg=True, agg_ok=False)
        for p in spec.partition_by:
            self.check_expr(p, where, agg_ok=False)
        for o in spec.order_by:
            self.check_expr(o.expr, where, agg_ok=False)

    # -- whole context ---------------------------------------------------
    def run(self) -> List[PlanIssue]:
        ctx = self.ctx
        if ctx.limit is not None and ctx.limit < 0:
            self.issue("BAD_LIMIT", f"LIMIT must be >= 0, got {ctx.limit}", "LIMIT")
        if ctx.offset is not None and ctx.offset < 0:
            self.issue("BAD_LIMIT", f"OFFSET must be >= 0, got {ctx.offset}", "OFFSET")

        for i, s in enumerate(ctx.select_list):
            where = f"select item {i + 1}"
            if isinstance(s, AggregationSpec):
                self.check_aggregation(s, where)
            elif isinstance(s, WindowSpec):
                self.check_window(s, where)
            else:
                self.check_expr(s, where, agg_ok=True)
        for spec in ctx.extra_aggregations:
            self.check_aggregation(spec, "extra aggregation")

        self.check_filter(ctx.filter, "WHERE", agg_ok=False)

        group_fps = set()
        for i, g in enumerate(ctx.group_by):
            where = f"GROUP BY key {i + 1}"
            group_fps.add(g.fingerprint())
            if g.is_literal:
                self.issue("UNGROUPABLE_KEY", f"cannot group by literal {g.value!r}", where)
                continue
            self.check_expr(g, where, agg_ok=False)

        self.check_filter(ctx.having, "HAVING", agg_ok=True)

        group_cols = {g.op for g in ctx.group_by if g.is_column}
        for i, ob in enumerate(ctx.order_by):
            where = f"ORDER BY item {i + 1}"
            self.check_expr(ob.expr, where, agg_ok=True)
            if (
                ctx.is_aggregate
                and ob.expr.is_column
                and ob.expr.op not in group_cols
                and ob.expr.op not in self.aliases
                and ob.expr.fingerprint() not in group_fps
                and ob.expr.op != "*"
            ):
                self.issue(
                    "BAD_ORDER_BY",
                    f"ORDER BY column {ob.expr.op!r} is neither a GROUP BY key nor a select alias "
                    "in an aggregate query",
                    where,
                )
        return self.issues


def collect_issues(ctx: QueryContext, schema=None) -> List[PlanIssue]:
    """All statically-detected defects of one plan (empty = plan is clean)."""
    return _Checker(ctx, schema).run()


def check_plan(ctx: QueryContext, schema=None) -> None:
    """Raise PlanCheckError for the first defect; no-op on clean plans."""
    issues = collect_issues(ctx, schema)
    if issues:
        raise issues[0].to_error()


# planner-path memo: plan_segment runs per segment, the ctx check is
# per-fingerprint — remember clean fingerprints so the per-segment cost is
# one dict hit (bounded; malformed plans never enter, they raise)
_CHECKED_FPS: Dict[str, bool] = {}
_CHECKED_CAP = 4096


def check_plan_cached(ctx: QueryContext, schema=None) -> None:
    fp = ctx.fingerprint()
    if fp in _CHECKED_FPS:
        return
    check_plan(ctx, schema)
    if len(_CHECKED_FPS) >= _CHECKED_CAP:
        _CHECKED_FPS.clear()
    _CHECKED_FPS[fp] = True
