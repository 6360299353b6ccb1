"""SQL front door: text -> QueryContext IR.

Trimmed copy of pinot_tpu/sql/parser.py (host-only) for single-table SQL:
SELECT / WHERE boolean algebra / GROUP BY / HAVING / ORDER BY /
LIMIT-OFFSET / query options.  It recognizes the JAX package's full set of
aggregation names (functions.ALL_AGG_NAMES), so one SQL text yields the
same QueryContext in both packages; names this slice does not implement
fail at plan time.  EXPLAIN, joins, set operations, subqueries, window
functions, GAPFILL, CASE and the funnel STEPS syntax raise
NotImplementedError here, naming the later slice that brings them.

Reference parity: CalciteSqlParser (pinot-common/.../sql/parsers/
CalciteSqlParser.java) compiling SQL text into the Thrift PinotQuery IR, plus
the `SET key=value;` query-option prelude (QueryOptionsUtils analog,
pinot-common/.../common/utils/config/QueryOptionsUtils.java).

Re-design: no Calcite/sqlglot dependency — a small hand-rolled lexer and
recursive-descent parser for the Pinot SQL surface (SELECT / WHERE boolean
algebra / GROUP BY / HAVING / ORDER BY / LIMIT-OFFSET / query options).
The grammar targets QueryContext directly; there is no intermediate AST to
keep the planner's input canonical (predicates normalised to EQ/IN/RANGE
exactly like Pinot's predicate contexts).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple, Union

from pinot_tpu_torch.query.functions import is_agg_function
from pinot_tpu_torch.query.ir import (
    AggregationSpec,
    Expr,
    ExprKind,
    FilterNode,
    FilterOp,
    OrderByExpr,
    Predicate,
    PredicateType,
    QueryContext,
    map_expr_columns,
    map_filter_columns,
)


def _substitute_alias_expr(e: Expr, mapping: Dict[str, Expr]) -> Expr:
    """Replace bare-column references to select aliases with the aliased
    expression (Calcite resolves ORDER BY/HAVING aliases the same way).

    Does NOT descend into aggregation calls: columns inside SUM(v) resolve
    against the table even when an alias shadows the name (MySQL/Calcite
    resolution — otherwise `SELECT year AS v, SUM(v) ... HAVING SUM(v)>k`
    silently becomes SUM(year))."""
    if e.is_column and e.op in mapping:
        return mapping[e.op]
    if e.kind is ExprKind.CALL and not is_agg_function(e.op):
        new_args = tuple(_substitute_alias_expr(a, mapping) for a in e.args)
        if new_args != e.args:
            return Expr(ExprKind.CALL, op=e.op, value=e.value, args=new_args)
    return e


def _substitute_alias_filter(node: FilterNode, mapping: Dict[str, Expr]) -> FilterNode:
    if node.op is FilterOp.PRED:
        p = node.predicate
        new_lhs = _substitute_alias_expr(p.lhs, mapping)
        if new_lhs is not p.lhs:
            return FilterNode.pred(dataclasses.replace(p, lhs=new_lhs))
        return node
    return FilterNode(
        node.op,
        children=tuple(_substitute_alias_filter(c, mapping) for c in node.children),
        predicate=node.predicate,
    )


class SqlParseError(ValueError):
    pass


def _contains_agg(e: Expr) -> bool:
    if not isinstance(e, Expr) or e.kind is not ExprKind.CALL:
        return False
    if is_agg_function(e.op):
        return True
    return any(_contains_agg(a) for a in e.args)


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------
_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|=|<|>|\+|-|\*|/|%|\(|\)|,|;|\.)
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "and", "or", "not", "in", "between", "like", "is", "null",
    "as", "asc", "desc", "nulls", "first", "last", "set", "distinct",
    "true", "false", "filter", "option",
    "join", "on", "inner", "left", "right", "full", "cross", "outer",
    "over", "partition", "union", "intersect", "except", "all",
    # NOTE: explain/plan/for are intentionally NOT keywords — they are
    # matched as words only in the EXPLAIN PLAN FOR prefix so columns named
    # `plan` keep working
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: Any, pos: int):
        self.kind = kind  # "number" | "string" | "ident" | "kw" | "op" | "eof"
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    n = len(sql)
    while i < n:
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SqlParseError(f"unexpected character {sql[i]!r} at position {i}")
        i = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "number":
            if "." in text or "e" in text or "E" in text:
                out.append(Token("number", float(text), m.start()))
            else:
                out.append(Token("number", int(text), m.start()))
        elif kind == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"), m.start()))
        elif kind == "qident":
            out.append(Token("ident", text[1:-1].replace('""', '"'), m.start()))
        elif kind == "ident":
            low = text.lower()
            if low in KEYWORDS:
                out.append(Token("kw", low, m.start()))
            else:
                out.append(Token("ident", text, m.start()))
        else:
            out.append(Token("op", text, m.start()))
    out.append(Token("eof", None, n))
    return out


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------
class _Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ---------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        return self.cur.kind == "kw" and self.cur.value in kws

    def at_op(self, *ops: str) -> bool:
        return self.cur.kind == "op" and self.cur.value in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            self.fail(f"expected {kw.upper()}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.fail(f"expected {op!r}")

    def fail(self, msg: str):
        t = self.cur
        raise SqlParseError(f"{msg} at position {t.pos} (near {t.value!r}) in: {self.sql!r}")

    # -- entry -----------------------------------------------------------
    def parse(self) -> QueryContext:
        options = {}
        if self.cur.kind == "ident" and str(self.cur.value).lower() == "explain":
            raise NotImplementedError("EXPLAIN is a later slice of the port")
        # Pinot option prelude: SET key = value; ... SELECT ...
        while self.at_kw("set"):
            self.advance()
            if self.cur.kind not in ("ident", "kw"):
                self.fail("expected option name after SET")
            name = self.advance().value
            self.expect_op("=")
            options[str(name)] = self.literal_value()
            self.expect_op(";")
        ctx = self.select_statement(options)
        if self.at_kw("union", "intersect", "except"):
            raise NotImplementedError("set operations are a later slice of the port")
        self.accept_op(";")
        if self.cur.kind != "eof":
            self.fail("unexpected trailing input")
        return ctx

    def select_statement(self, options) -> QueryContext:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        select_list: List[Union[Expr, AggregationSpec]] = []
        aliases: List[Optional[str]] = []
        while True:
            item, alias = self.select_item()
            select_list.append(item)
            aliases.append(alias)
            if not self.accept_op(","):
                break
        self.expect_kw("from")
        if self.cur.kind not in ("ident",):
            self.fail("expected table name")
        table = self.advance().value
        table_alias = self.table_alias()
        if self.at_kw("join", "inner", "left", "right", "full", "cross"):
            raise NotImplementedError("JOIN queries are a later slice of the port (MSE joins)")

        where = None
        if self.accept_kw("where"):
            where = self.boolean_expr()
        group_by: List[Expr] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            while True:
                group_by.append(self.expr())
                if not self.accept_op(","):
                    break
        having = None
        if self.accept_kw("having"):
            having = self.boolean_expr()
        order_by: List[OrderByExpr] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                # Plain expression parse: an aggregation call like SUM(v)
                # stays an Expr.call — reduce resolves its fingerprint against
                # the aggregation results (env.setdefault in _reduce_groupby).
                e = self.expr()
                asc = True
                if self.accept_kw("desc"):
                    asc = False
                else:
                    self.accept_kw("asc")
                nulls_last = True
                if self.accept_kw("nulls"):
                    if self.accept_kw("first"):
                        nulls_last = False
                    else:
                        self.expect_kw("last")
                order_by.append(OrderByExpr(e, ascending=asc, nulls_last=nulls_last))
                if not self.accept_op(","):
                    break
        limit = 10  # Pinot's default LIMIT 10
        offset = 0
        if self.at_kw("limit"):
            # kept so options (and fingerprints) match the JAX parser's
            options["__hasExplicitLimit__"] = True
        if self.accept_kw("limit"):
            limit = self.int_literal()
            if self.accept_op(","):
                # MySQL style LIMIT offset, count
                offset = limit
                limit = self.int_literal()
            elif self.accept_kw("offset"):
                offset = self.int_literal()
        # trailing OPTION(key=value, ...) — legacy Pinot option syntax
        if self.accept_kw("option"):
            self.expect_op("(")
            while True:
                if self.cur.kind not in ("ident", "kw"):
                    self.fail("expected option name")
                name = self.advance().value
                self.expect_op("=")
                options[str(name)] = self.literal_value()
                if not self.accept_op(","):
                    break
            self.expect_op(")")

        # Resolve select aliases referenced in ORDER BY / HAVING.  Plain
        # expressions substitute in-place (so `SELECT ts AS t ... ORDER BY t`
        # plans on the real column); aggregation aliases stay as bare columns
        # — reduce registers alias -> final array in its env, and the planner
        # skips them in _needed_columns.  Alias wins over a same-named
        # physical column only when the physical column doesn't exist
        # (checked planner-side; here substitution is unconditional for
        # expression aliases, matching MySQL/Calcite alias-first resolution).
        expr_aliases: Dict[str, Expr] = {}
        for item, alias in zip(select_list, aliases):
            if alias and isinstance(item, Expr) and not (item.is_column and item.op == alias):
                expr_aliases[alias] = item
        if expr_aliases:
            order_by = [
                OrderByExpr(_substitute_alias_expr(o.expr, expr_aliases), o.ascending, o.nulls_last)
                for o in order_by
            ]
            if having is not None:
                having = _substitute_alias_filter(having, expr_aliases)

        if distinct:
            # DISTINCT c1, c2 == GROUP BY c1, c2 selecting keys only (Pinot
            # executes DISTINCT via DistinctOperator; group-by is equivalent).
            if any(isinstance(s, AggregationSpec) for s in select_list):
                self.fail("SELECT DISTINCT with aggregations is not supported")
            group_by = [s for s in select_list if isinstance(s, Expr)]
            # DISTINCT defaults to LIMIT 10 like Pinot

        # Aggregations referenced by ORDER BY/HAVING/select EXPRESSIONS but
        # not selected directly are computed as hidden extras (Pinot permits
        # ORDER BY SUM(v) and post-aggregation arithmetic like
        # SELECT SUM(a)/COUNT(*)); reduce resolves their fingerprints and
        # evaluates the surrounding arithmetic host-side over final arrays.
        extra_aggs: List[AggregationSpec] = []
        if group_by or any(
            isinstance(s, Expr) and _contains_agg(s) for s in select_list
        ):
            selected_fps = {
                s.fingerprint() for s in select_list if isinstance(s, AggregationSpec)
            }

            def _maybe_extra(e: Expr) -> None:
                if (
                    isinstance(e, Expr)
                    and e.kind is ExprKind.CALL
                    and is_agg_function(e.op)
                ):
                    spec = self._call_to_agg(e)
                    if spec.fingerprint() not in selected_fps and not any(
                        spec.fingerprint() == x.fingerprint() for x in extra_aggs
                    ):
                        extra_aggs.append(spec)
                    return
                if isinstance(e, Expr):
                    for a in e.args:
                        _maybe_extra(a)

            for s in select_list:
                if isinstance(s, Expr) and s.kind is ExprKind.CALL:
                    _maybe_extra(s)
            for o in order_by:
                _maybe_extra(o.expr)
            if having is not None:
                for pred in having.predicates():
                    _maybe_extra(pred.lhs)

        # Single-table queries: resolve alias.column qualifiers here — the
        # engine knows nothing about aliases.
        known = {table}
        if table_alias:
            known.add(table_alias)

        def strip_q(e: Expr) -> Expr:
            if "." in e.op:
                q, c = e.op.split(".", 1)
                if q not in known:
                    raise SqlParseError(
                        f"unknown table alias {q!r} in {e.op!r} "
                        f"(FROM {table}{' ' + table_alias if table_alias else ''})"
                    )
                return Expr.col(c)
            return e

        def strip_agg(s: AggregationSpec) -> AggregationSpec:
            return dataclasses.replace(
                s,
                expr=map_expr_columns(s.expr, strip_q) if s.expr is not None else None,
                filter=map_filter_columns(s.filter, strip_q),
            )

        def strip_item(s):
            if isinstance(s, AggregationSpec):
                return strip_agg(s)
            return map_expr_columns(s, strip_q)

        select_list = [strip_item(s) for s in select_list]
        group_by = [map_expr_columns(g, strip_q) for g in group_by]
        where = map_filter_columns(where, strip_q)
        having = map_filter_columns(having, strip_q)
        order_by = [
            OrderByExpr(map_expr_columns(o.expr, strip_q), o.ascending, o.nulls_last)
            for o in order_by
        ]
        extra_aggs = [strip_agg(s) for s in extra_aggs]

        return QueryContext(
            table=table,
            select_list=select_list,
            select_aliases=aliases,
            table_alias=table_alias,
            filter=where,
            group_by=group_by,
            having=having,
            order_by=order_by,
            limit=limit,
            offset=offset,
            options=options,
            extra_aggregations=extra_aggs,
        )

    # -- FROM clause: table alias ----------------------------------------
    def table_alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            if self.cur.kind != "ident":
                self.fail("expected table alias after AS")
            return self.advance().value
        if self.cur.kind == "ident":
            return self.advance().value
        return None

    # -- select items ----------------------------------------------------
    def select_item(self) -> Tuple[Union[Expr, AggregationSpec], Optional[str]]:
        item = self.expr_or_agg()
        alias = None
        if self.accept_kw("as"):
            if self.cur.kind not in ("ident", "string"):
                self.fail("expected alias after AS")
            alias = self.advance().value
        elif self.cur.kind == "ident":
            alias = self.advance().value
        return item, alias

    # Aggregation names the engine knows about but has not implemented yet —
    # parsed specially so the user sees "unsupported aggregation" instead of
    # a misleading selection-expression error.
    _KNOWN_UNIMPLEMENTED_AGGS = frozenset({"distinctcountrawhll", "distinctcountthetasketch"})

    def expr_or_agg(self) -> Union[Expr, AggregationSpec]:
        """Expression that may be a top-level aggregation call."""
        e = self.expr()
        if isinstance(e, Expr) and e.kind.name == "CALL" and e.op in self._KNOWN_UNIMPLEMENTED_AGGS:
            self.fail(f"aggregation function {e.op!r} is not supported yet")
        if isinstance(e, Expr) and e.kind.name == "CALL" and e.op == "gapfill":
            raise NotImplementedError("GAPFILL is a later slice of the port")
        if isinstance(e, Expr) and e.kind.name == "CALL" and self.at_kw("over"):
            raise NotImplementedError("window functions are a later slice of the port (slice 2)")
        if isinstance(e, Expr) and e.kind.name == "CALL" and is_agg_function(e.op):
            spec = self._call_to_agg(e)
            # FILTER (WHERE ...) clause — Pinot filtered aggregations
            if self.accept_kw("filter"):
                self.expect_op("(")
                self.expect_kw("where")
                f = self.boolean_expr()
                self.expect_op(")")
                spec = AggregationSpec(spec.function, spec.expr, filter=f, literal_args=spec.literal_args)
            return spec
        return e

    @staticmethod
    def _call_to_agg(e: Expr) -> AggregationSpec:
        args = list(e.args)
        if e.op == "count" and len(args) == 1 and args[0].is_column and args[0].op == "*":
            return AggregationSpec("count", None)
        if e.op.replace("_", "") in ("funnelcount", "funnelcompletecount", "funnelmaxstep"):
            raise NotImplementedError(f"{e.op.upper()} is a later slice of the port (slice 4)")
        expr = args[0] if args else None
        lits = tuple(a.value for a in args[1:] if a.is_literal)
        extra = tuple(a for a in args[1:] if not a.is_literal)
        return AggregationSpec(e.op, expr, literal_args=lits, extra_exprs=extra)

    # -- boolean (filter) grammar ---------------------------------------
    def boolean_expr(self) -> FilterNode:
        node = self.boolean_term()
        while self.accept_kw("or"):
            rhs = self.boolean_term()
            if node.op.name == "OR":
                node = FilterNode(node.op, children=node.children + (rhs,))
            else:
                node = FilterNode.or_(node, rhs)
        return node

    def boolean_term(self) -> FilterNode:
        node = self.boolean_factor()
        while self.accept_kw("and"):
            rhs = self.boolean_factor()
            if node.op.name == "AND":
                node = FilterNode(node.op, children=node.children + (rhs,))
            else:
                node = FilterNode.and_(node, rhs)
        return node

    def boolean_factor(self) -> FilterNode:
        if self.accept_kw("not"):
            return FilterNode.not_(self.boolean_factor())
        # parenthesized boolean vs parenthesized arithmetic: try boolean
        if self.at_op("("):
            save = self.i
            self.advance()
            try:
                inner = self.boolean_expr()
                self.expect_op(")")
                return inner
            except SqlParseError:
                self.i = save  # fall through to predicate over arithmetic expr
        return self.predicate()

    def predicate(self) -> FilterNode:
        lhs = self.expr()
        # special boolean-function predicates used bare: text_match(col,'x')
        if isinstance(lhs, Expr) and lhs.kind.name == "CALL" and lhs.op in (
            "text_match", "json_match", "regexp_like", "vector_similarity",
        ):
            return self._special_call_predicate(lhs)
        negate = self.accept_kw("not")
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.at_kw("select"):
                raise NotImplementedError("IN (SELECT ...) subqueries are a later slice of the port")
            vals = [self.literal_value()]
            while self.accept_op(","):
                vals.append(self.literal_value())
            self.expect_op(")")
            pt = PredicateType.NOT_IN if negate else PredicateType.IN
            return FilterNode.pred(Predicate(pt, lhs, values=tuple(vals)))
        if self.accept_kw("between"):
            lo = self.add_expr()
            self.expect_kw("and")
            hi = self.add_expr()
            node = FilterNode.pred(
                Predicate(PredicateType.RANGE, lhs, lower=self._const(lo), upper=self._const(hi))
            )
            return FilterNode.not_(node) if negate else node
        if self.accept_kw("like"):
            pat = self.literal_value()
            node = FilterNode.pred(Predicate(PredicateType.LIKE, lhs, values=(pat,)))
            return FilterNode.not_(node) if negate else node
        if negate:
            self.fail("expected IN/BETWEEN/LIKE after NOT")
        if self.accept_kw("is"):
            neg = self.accept_kw("not")
            self.expect_kw("null")
            pt = PredicateType.IS_NOT_NULL if neg else PredicateType.IS_NULL
            return FilterNode.pred(Predicate(pt, lhs))
        for op, make in (
            ("=", lambda v: Predicate(PredicateType.EQ, lhs, values=(v,))),
            ("!=", lambda v: Predicate(PredicateType.NEQ, lhs, values=(v,))),
            ("<>", lambda v: Predicate(PredicateType.NEQ, lhs, values=(v,))),
            (">=", lambda v: Predicate(PredicateType.RANGE, lhs, lower=v)),
            (">", lambda v: Predicate(PredicateType.RANGE, lhs, lower=v, lower_inclusive=False)),
            ("<=", lambda v: Predicate(PredicateType.RANGE, lhs, upper=v)),
            ("<", lambda v: Predicate(PredicateType.RANGE, lhs, upper=v, upper_inclusive=False)),
        ):
            if self.accept_op(op):
                rhs = self.add_expr()
                return FilterNode.pred(make(self._const(rhs)))
        # bare boolean column: `WHERE flag` == flag = true
        if isinstance(lhs, Expr) and lhs.is_column:
            return FilterNode.pred(Predicate(PredicateType.EQ, lhs, values=(True,)))
        self.fail("expected comparison operator")

    def _special_call_predicate(self, call: Expr) -> FilterNode:
        args = call.args
        if len(args) < 2 or not args[0].is_column:
            self.fail(f"{call.op}(column, pattern...) expected")
        pt = {
            "text_match": PredicateType.TEXT_MATCH,
            "json_match": PredicateType.JSON_MATCH,
            "regexp_like": PredicateType.REGEXP_LIKE,
            "vector_similarity": PredicateType.VECTOR_SIMILARITY,
        }[call.op]
        vals = tuple(a.value if a.is_literal else a for a in args[1:])
        return FilterNode.pred(Predicate(pt, args[0], values=vals))

    @staticmethod
    def _const(e: Expr) -> Any:
        if not e.is_literal:
            raise SqlParseError(f"expected a literal comparison value, got expression {e}")
        return e.value

    # -- arithmetic expression grammar ----------------------------------
    def expr(self) -> Expr:
        return self.add_expr()

    def add_expr(self) -> Expr:
        e = self.mul_expr()
        while self.at_op("+", "-"):
            op = self.advance().value
            rhs = self.mul_expr()
            e = self._fold(Expr.call("plus" if op == "+" else "minus", e, rhs))
        return e

    def mul_expr(self) -> Expr:
        e = self.unary_expr()
        while self.at_op("*", "/", "%"):
            # `*` only means multiply if a term follows (disambiguate COUNT(*))
            op = self.advance().value
            rhs = self.unary_expr()
            name = {"*": "times", "/": "divide", "%": "mod"}[op]
            e = self._fold(Expr.call(name, e, rhs))
        return e

    def unary_expr(self) -> Expr:
        if self.accept_op("-"):
            e = self.unary_expr()
            if e.is_literal:
                return Expr.lit(-e.value)
            return Expr.call("neg", e)
        self.accept_op("+")
        return self.primary()

    @staticmethod
    def _fold(e: Expr) -> Expr:
        """Constant-fold literal arithmetic so `v > 10*2` stays a literal."""
        if e.kind.name == "CALL" and all(a.is_literal for a in e.args):
            import operator

            ops = {
                "plus": operator.add, "minus": operator.sub,
                "times": operator.mul, "mod": operator.mod,
                "divide": operator.truediv,
            }
            fn = ops.get(e.op)
            if fn is not None:
                try:
                    return Expr.lit(fn(*(a.value for a in e.args)))
                except Exception:
                    return e
        return e

    def primary(self) -> Expr:
        t = self.cur
        if t.kind == "number":
            self.advance()
            return Expr.lit(t.value)
        if t.kind == "string":
            self.advance()
            return Expr.lit(t.value)
        if t.kind == "kw" and t.value in ("true", "false"):
            self.advance()
            return Expr.lit(t.value == "true")
        if t.kind == "kw" and t.value == "null":
            self.advance()
            return Expr.lit(None)
        if self.accept_op("("):
            e = self.expr()
            self.expect_op(")")
            return e
        if self.accept_op("*"):
            return Expr.col("*")
        if t.kind == "ident" and str(t.value).lower() == "case":
            raise NotImplementedError("CASE expressions are a later slice of the port (slice 2)")
        if t.kind == "ident" or (t.kind == "kw" and t.value in ("filter",)):
            name = self.advance().value
            if self.accept_op("("):
                # CAST(expr AS TYPE) special form
                if str(name).lower() == "cast":
                    e = self.expr()
                    self.expect_kw("as")
                    if self.cur.kind not in ("ident", "kw"):
                        self.fail("expected type name in CAST")
                    target = self.advance().value
                    self.expect_op(")")
                    return Expr.call("cast", e, Expr.lit(str(target).upper()))
                # function call
                args: List[Expr] = []
                if self.accept_op("*"):
                    args.append(Expr.col("*"))
                    self.expect_op(")")
                    return Expr.call(name, *args)
                if str(name).lower() == "steps":
                    raise NotImplementedError("funnel STEPS(...) is a later slice of the port (slice 4)")
                if not self.at_op(")"):
                    # DISTINCT inside agg: count(distinct x) -> distinctcount
                    if self.accept_kw("distinct"):
                        arg = self.expr()
                        self.expect_op(")")
                        if str(name).lower() == "count":
                            return Expr.call("distinctcount", arg)
                        # silently dropping DISTINCT would return wrong
                        # results (SUM(DISTINCT x) != SUM(x))
                        self.fail(f"{name}(DISTINCT ...) is not supported")
                    args.append(self.expr())
                    while self.accept_op(","):
                        args.append(self.expr())
                self.expect_op(")")
                return Expr.call(name, *args)
            # qualified reference: alias.column
            if self.accept_op("."):
                if self.cur.kind not in ("ident", "kw"):
                    self.fail("expected column name after '.'")
                return Expr.col(f"{name}.{self.advance().value}")
            return Expr.col(name)
        self.fail("expected expression")

    # -- literal helpers -------------------------------------------------
    def literal_value(self) -> Any:
        t = self.cur
        if t.kind in ("number", "string"):
            self.advance()
            return t.value
        if t.kind == "kw" and t.value in ("true", "false"):
            self.advance()
            return t.value == "true"
        if t.kind == "kw" and t.value == "null":
            self.advance()
            return None
        if self.accept_op("-"):
            v = self.literal_value()
            return -v
        if t.kind == "ident":
            # bare identifier option values, e.g. SET mode=fast;
            self.advance()
            return t.value
        self.fail("expected literal")

    def int_literal(self) -> int:
        t = self.cur
        if t.kind == "number" and isinstance(t.value, int):
            self.advance()
            return t.value
        self.fail("expected integer literal")


def parse_query(sql: str) -> QueryContext:
    """Parse one SQL statement into a QueryContext (CalciteSqlParser analog)."""
    return _Parser(sql).parse()
