"""SQL front door: text -> QueryContext IR.

Copy of pinot_tpu/sql/parser.py (host-only):
SELECT / WHERE boolean algebra / GROUP BY / HAVING / ORDER BY /
LIMIT-OFFSET / query options.  It recognizes the JAX package's full set of
aggregation names (functions.ALL_AGG_NAMES), so one SQL text yields the
same QueryContext in both packages; names the port does not implement
fail at plan time.  CASE, FILTER (WHERE ...) and window functions
(fn(...) OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE frame])) parse as
in the JAX package, and so do the funnel family's STEPS, CORRELATEBY and
TIMESTAMPBY arguments, and so do EXPLAIN [ANALYZE] PLAN FOR, UNION [ALL] /
INTERSECT / EXCEPT (INTERSECT binding tighter), IN / NOT IN (SELECT ...)
and GAPFILL(...), and so do INNER / LEFT [OUTER] JOIN ... ON a = b clauses
(equi-joins; RIGHT, FULL and CROSS raise SqlParseError as there).  Table
qualifiers are stripped here only when the query has no join; a join's
qualifiers are resolved by the multi-stage planner (mse/plan.py).

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
    GapfillSpec,
    JoinClause,
    Subquery,
    map_expr_columns,
    map_filter_columns,
    WindowSpec,
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


def _filter_to_expr(node: FilterNode) -> Expr:
    """CASE condition -> boolean expression ops (__and/__or/__not/__eq/...)
    the transform layer evaluates on device."""
    if node.op is FilterOp.AND:
        return Expr.call("__and", *[_filter_to_expr(c) for c in node.children])
    if node.op is FilterOp.OR:
        return Expr.call("__or", *[_filter_to_expr(c) for c in node.children])
    if node.op is FilterOp.NOT:
        return Expr.call("__not", _filter_to_expr(node.children[0]))
    p = node.predicate
    if p.ptype is PredicateType.EQ:
        return Expr.call("__eq", p.lhs, Expr.lit(p.values[0]))
    if p.ptype is PredicateType.NEQ:
        return Expr.call("__not", Expr.call("__eq", p.lhs, Expr.lit(p.values[0])))
    if p.ptype is PredicateType.IN:
        return Expr.call("__in", p.lhs, *[Expr.lit(v) for v in p.values])
    if p.ptype is PredicateType.NOT_IN:
        return Expr.call("__not", Expr.call("__in", p.lhs, *[Expr.lit(v) for v in p.values]))
    if p.ptype is PredicateType.RANGE:
        parts = []
        if p.lower is not None:
            parts.append(Expr.call("__ge" if p.lower_inclusive else "__gt", p.lhs, Expr.lit(p.lower)))
        if p.upper is not None:
            parts.append(Expr.call("__le" if p.upper_inclusive else "__lt", p.lhs, Expr.lit(p.upper)))
        if len(parts) == 1:
            return parts[0]
        return Expr.call("__and", *parts)
    if p.ptype is PredicateType.IS_NULL:
        return Expr.call("__isnull", p.lhs)
    if p.ptype is PredicateType.IS_NOT_NULL:
        return Expr.call("__not", Expr.call("__isnull", p.lhs))
    raise SqlParseError(f"unsupported predicate {p.ptype.value} inside a CASE condition")


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
        self._gapfill = None  # GapfillSpec captured by select_statement

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
        # EXPLAIN PLAN FOR SELECT ... (Pinot explain syntax) or
        # EXPLAIN ANALYZE SELECT ... (execute with tracing forced, join the
        # operator tree with measured ms/rows); matched as words, not
        # keywords, so `plan`/`for`/`analyze` stay valid identifiers
        if self.cur.kind == "ident" and str(self.cur.value).lower() == "explain":
            self.advance()
            if self.cur.kind in ("ident", "kw") and str(self.cur.value).lower() == "analyze":
                self.advance()
                options["__analyze__"] = True
                options["trace"] = True
            else:
                for w in ("plan", "for"):
                    if not (self.cur.kind in ("ident", "kw") and str(self.cur.value).lower() == w):
                        self.fail("expected PLAN FOR or ANALYZE after EXPLAIN")
                    self.advance()
                options["__explain__"] = True
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
        # set operations: INTERSECT binds tighter than UNION/EXCEPT (SQL
        # standard); `a UNION b INTERSECT c` = a UNION (b INTERSECT c).
        # Tight ops fold into the PRECEDING term's own set_ops; loose ops
        # chain left-associatively at the top level.
        last_term = ctx
        while self.at_kw("union", "intersect", "except"):
            op = self.advance().value
            all_flag = self.accept_kw("all")
            if all_flag and op != "union":
                self.fail(f"{op.upper()} ALL is not supported")
            rhs = self.select_statement(dict(options))
            if op == "intersect" and last_term is not ctx:
                last_term.set_ops.append((op, all_flag, rhs))
            else:
                ctx.set_ops.append((op, all_flag, rhs))
                last_term = rhs
        self.accept_op(";")
        if self.cur.kind != "eof":
            self.fail("unexpected trailing input")
        return ctx

    def select_statement(self, options) -> QueryContext:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        select_list: List[Union[Expr, AggregationSpec]] = []
        aliases: List[Optional[str]] = []
        self._gapfill = None
        while True:
            item, alias = self.select_item()
            select_list.append(item)
            aliases.append(alias)
            if not self.accept_op(","):
                break
        # capture before FROM/WHERE: a subquery's select_statement resets
        # the parser-level slot
        gapfill = self._gapfill
        self._gapfill = None
        self.expect_kw("from")
        if self.cur.kind not in ("ident",):
            self.fail("expected table name")
        table = self.advance().value
        table_alias = self.table_alias()
        joins = self.join_clauses()

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
        # SSE engines know nothing about aliases (only the MSE resolver
        # strips qualifiers, and it only runs for join queries).
        if not joins:
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
                if isinstance(s, WindowSpec):
                    return dataclasses.replace(
                        s,
                        expr=map_expr_columns(s.expr, strip_q) if s.expr is not None else None,
                        partition_by=tuple(map_expr_columns(p, strip_q) for p in s.partition_by),
                        order_by=tuple(
                            OrderByExpr(map_expr_columns(o.expr, strip_q), o.ascending, o.nulls_last)
                            for o in s.order_by
                        ),
                    )
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
            if gapfill is not None:
                gapfill = dataclasses.replace(
                    gapfill,
                    time_expr=map_expr_columns(gapfill.time_expr, strip_q),
                    fills=tuple((map_expr_columns(t, strip_q), m) for t, m in gapfill.fills),
                    series=tuple(map_expr_columns(s, strip_q) for s in gapfill.series),
                )

        return QueryContext(
            table=table,
            select_list=select_list,
            select_aliases=aliases,
            table_alias=table_alias,
            joins=joins,
            filter=where,
            group_by=group_by,
            having=having,
            order_by=order_by,
            limit=limit,
            offset=offset,
            options=options,
            extra_aggregations=extra_aggs,
            gapfill=gapfill,
        )

    # -- FROM clause: aliases + joins -----------------------------------
    def table_alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            if self.cur.kind != "ident":
                self.fail("expected table alias after AS")
            return self.advance().value
        if self.cur.kind == "ident":
            return self.advance().value
        return None

    def join_clauses(self) -> List[JoinClause]:
        joins: List[JoinClause] = []
        while self.at_kw("join", "inner", "left", "right", "full", "cross"):
            jt = "inner"
            if self.accept_kw("inner"):
                pass
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                jt = "left"
            elif self.at_kw("right", "full", "cross"):
                self.fail(f"{self.cur.value.upper()} JOIN is not supported (INNER/LEFT only)")
            self.expect_kw("join")
            if self.cur.kind != "ident":
                self.fail("expected table name after JOIN")
            tbl = self.advance().value
            alias = self.table_alias()
            self.expect_kw("on")
            lhs = self.expr()
            self.expect_op("=")
            rhs = self.expr()
            if not (lhs.is_column and rhs.is_column):
                self.fail("JOIN ON requires column = column (equi-join keys)")
            joins.append(JoinClause(tbl, alias, jt, lhs, rhs))
        return joins

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

    _WINDOW_FNS = frozenset({
        "row_number", "rank", "dense_rank", "ntile",
        "lag", "lead", "first_value", "last_value",
        "sum", "count", "avg", "min", "max", "bool_and", "bool_or",
    })

    def _at_word(self, w: str) -> bool:
        return self.cur.kind in ("ident", "kw") and str(self.cur.value).lower() == w

    def _accept_word(self, w: str) -> bool:
        if self._at_word(w):
            self.advance()
            return True
        return False

    def _expect_word(self, w: str) -> None:
        if not self._accept_word(w):
            self.fail(f"expected {w.upper()} in window frame")

    def _frame_bound(self, is_lower: bool) -> Optional[float]:
        """One frame bound as a signed offset: None = UNBOUNDED, 0 = CURRENT
        ROW, -k = k PRECEDING, +k = k FOLLOWING (WindowFrame.java bounds)."""
        if self._accept_word("unbounded"):
            if is_lower:
                self._expect_word("preceding")
            else:
                self._expect_word("following")
            return None
        if self._accept_word("current"):
            self._expect_word("row")
            return 0
        if self.cur.kind != "number":
            self.fail("expected UNBOUNDED, CURRENT ROW or <n> PRECEDING/FOLLOWING")
        k = self.advance().value
        if self._accept_word("preceding"):
            return -k
        self._expect_word("following")
        return k

    def _window_frame(self) -> Tuple[str, Optional[float], Optional[float]]:
        """[ROWS|RANGE] [BETWEEN <bound> AND <bound> | <bound>]."""
        if self._accept_word("rows"):
            mode = "rows"
        elif self._accept_word("range"):
            mode = "range"
        else:
            return "range_all", None, None
        if self._accept_word("between"):
            lo = self._frame_bound(True)
            self._expect_word("and")
            hi = self._frame_bound(False)
            if lo is not None and hi is not None and lo > hi:
                self.fail("window frame start must not be after frame end")
        else:
            lo = self._frame_bound(True)
            hi = 0  # shorthand: <bound> == BETWEEN <bound> AND CURRENT ROW
            if lo is not None and lo > 0:
                self.fail("shorthand window frame bound must be UNBOUNDED/k PRECEDING or CURRENT ROW")
        if mode == "rows":
            for b in (lo, hi):
                if b is not None and float(b) != int(b):
                    self.fail("ROWS frame bounds must be integers")
            lo = None if lo is None else int(lo)
            hi = None if hi is None else int(hi)
        return mode, lo, hi

    def _gapfill_item(self, e: Expr) -> Expr:
        """Interpret a parsed GAPFILL(...) call: stash the GapfillSpec on the
        parser (select_statement collects it) and return the time expression
        as the select item (the bucket output column)."""
        if len(e.args) < 4:
            self.fail("GAPFILL requires (time_expr, start, end, step, ...)")
        time_expr = e.args[0]

        def _int_lit(a: Expr, what: str) -> int:
            if not a.is_literal:
                self.fail(f"GAPFILL {what} must be a literal")
            try:
                return int(a.value)
            except (TypeError, ValueError):
                self.fail(f"GAPFILL {what} must be an integer (got {a.value!r})")

        start = _int_lit(e.args[1], "start")
        end = _int_lit(e.args[2], "end")
        step = _int_lit(e.args[3], "step")
        if step <= 0:
            self.fail("GAPFILL step must be positive")
        fills: List[tuple] = []
        series: List[Expr] = []
        for a in e.args[4:]:
            if not (isinstance(a, Expr) and a.kind.name == "CALL"):
                self.fail(f"unexpected GAPFILL argument {a}")
            if a.op == "fill":
                if len(a.args) != 2 or not a.args[1].is_literal:
                    self.fail("FILL requires (target, 'mode')")
                mode = str(a.args[1].value).upper()
                if mode not in ("FILL_PREVIOUS_VALUE", "FILL_DEFAULT_VALUE"):
                    self.fail(f"unknown FILL mode {mode!r}")
                fills.append((a.args[0], mode))
            elif a.op == "timeserieson":
                series.extend(a.args)
            else:
                self.fail(f"unexpected GAPFILL argument {a.op!r}")
        if self._gapfill is not None:
            self.fail("only one GAPFILL per query")
        self._gapfill = GapfillSpec(
            time_expr, start, end, step, tuple(fills), tuple(series)
        )
        return time_expr

    def expr_or_agg(self) -> Union[Expr, AggregationSpec]:
        """Expression that may be a top-level aggregation call."""
        e = self.expr()
        if isinstance(e, Expr) and e.kind.name == "CALL" and e.op in self._KNOWN_UNIMPLEMENTED_AGGS:
            self.fail(f"aggregation function {e.op!r} is not supported yet")
        if isinstance(e, Expr) and e.kind.name == "CALL" and e.op == "gapfill":
            return self._gapfill_item(e)
        # window function: fn(...) OVER (PARTITION BY ... ORDER BY ...)
        if isinstance(e, Expr) and e.kind.name == "CALL" and self.at_kw("over"):
            if e.op not in self._WINDOW_FNS:
                self.fail(f"{e.op!r} is not a supported window function")
            self.advance()
            self.expect_op("(")
            partition: List[Expr] = []
            worder: List[OrderByExpr] = []
            if self.accept_kw("partition"):
                self.expect_kw("by")
                while True:
                    partition.append(self.expr())
                    if not self.accept_op(","):
                        break
            if self.accept_kw("order"):
                self.expect_kw("by")
                while True:
                    oe = self.expr()
                    asc = True
                    if self.accept_kw("desc"):
                        asc = False
                    else:
                        self.accept_kw("asc")
                    worder.append(OrderByExpr(oe, ascending=asc))
                    if not self.accept_op(","):
                        break
            frame, frame_lo, frame_hi = self._window_frame()
            self.expect_op(")")
            arg = None
            literal_args: Tuple = ()
            if e.op == "ntile":
                # NTILE(n): the single argument is the bucket count literal
                if len(e.args) != 1 or not e.args[0].is_literal:
                    self.fail("NTILE requires one literal bucket count")
                if int(e.args[0].value) < 1:
                    self.fail("NTILE bucket count must be >= 1")
                literal_args = (int(e.args[0].value),)
            elif e.op in ("lag", "lead"):
                # LAG/LEAD(expr [, offset [, default]])
                if not e.args:
                    self.fail(f"{e.op.upper()} requires an argument")
                arg = e.args[0]
                extras = []
                for a in e.args[1:]:
                    if not a.is_literal:
                        self.fail(f"{e.op.upper()} offset/default must be literals")
                    extras.append(a.value)
                if extras:
                    extras[0] = int(extras[0])
                literal_args = tuple(extras)
            elif e.args and not (e.args[0].is_column and e.args[0].op == "*"):
                arg = e.args[0]
            return WindowSpec(
                e.op, arg, tuple(partition), tuple(worder),
                frame, frame_lo, frame_hi, literal_args,
            )
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
            # FUNNELCOUNT(STEPS(c1, c2, ...), CORRELATEBY(col)) -> the
            # correlate column is the (codes) input, the step conditions are
            # extra boolean expressions (FunnelCountAggregationFunction)
            steps = next((a for a in args if not a.is_literal and a.op == "steps"), None)
            corr = next(
                (a for a in args if not a.is_literal and a.op in ("correlateby", "correlatedby", "correlate_by")),
                None,
            )
            if steps is None or corr is None or not steps.args or len(corr.args) != 1:
                raise SqlParseError(f"{e.op.upper()} needs STEPS(cond, ...) and CORRELATEBY(column) arguments")
            # TIMESTAMPBY(col) [, window] selects the ORDERED funnel: steps
            # must occur in timestamp order per correlate key, optionally all
            # within `window` (the timestamp column's units) of the chain's
            # first step.  The ts expr rides as the LAST extra expr; the
            # window literal flags ordered mode downstream.
            tsby = next((a for a in args if not a.is_literal and a.op in ("timestampby", "timestamp_by")), None)
            window = next((a.value for a in args if a.is_literal), None)
            extra = tuple(steps.args)
            lits = ()
            if tsby is not None:
                if len(tsby.args) != 1:
                    raise SqlParseError(f"{e.op.upper()} TIMESTAMPBY takes exactly one column")
                extra = extra + (tsby.args[0],)
                lits = (float(window) if window is not None else float("inf"),)
            elif window is not None:
                raise SqlParseError(f"{e.op.upper()} window argument requires TIMESTAMPBY(column)")
            return AggregationSpec(e.op, corr.args[0], extra_exprs=extra, literal_args=lits)
        expr = args[0] if args else None
        lits = tuple(a.value for a in args[1:] if a.is_literal)
        extra = tuple(a for a in args[1:] if not a.is_literal)
        return AggregationSpec(e.op, expr, literal_args=lits, extra_exprs=extra)

    def _case_expr(self) -> Expr:
        """CASE WHEN cond THEN expr ... [ELSE expr] END -> a `case` CALL
        whose args alternate (condition-as-expr, result): conditions convert
        through _filter_to_expr into boolean expression ops the transform
        layer evaluates on device (CaseTransformFunction analog)."""
        self.advance()  # CASE
        def word(w):
            t = self.cur
            if t.kind in ("ident", "kw") and str(t.value).lower() == w:
                self.advance()
                return True
            return False

        args: List[Expr] = []
        saw_when = False
        while word("when"):
            saw_when = True
            cond = self.boolean_expr()
            args.append(_filter_to_expr(cond))
            if not word("then"):
                self.fail("expected THEN in CASE")
            args.append(self.expr())
        if not saw_when:
            self.fail("expected WHEN in CASE")
        if word("else"):
            args.append(self.expr())
        else:
            args.append(Expr.lit(None))
        if not word("end"):
            self.fail("expected END closing CASE")
        return Expr.call("case", *args)

    # -- boolean (filter) grammar ---------------------------------------

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
                # IN (SELECT ...) — semi-join marker resolved by the engine
                sub = self.select_statement({})
                self.expect_op(")")
                pt = PredicateType.NOT_IN if negate else PredicateType.IN
                return FilterNode.pred(Predicate(pt, lhs, values=(Subquery(sub),)))
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
            return self._case_expr()
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
                # STEPS(cond, cond, ...) — the funnel family's step
                # conditions are BOOLEAN expressions, converted through the
                # CASE condition machinery into boolean expression ops
                if str(name).lower() == "steps":
                    conds: List[Expr] = []
                    if not self.at_op(")"):
                        conds.append(_filter_to_expr(self.boolean_expr()))
                        while self.accept_op(","):
                            conds.append(_filter_to_expr(self.boolean_expr()))
                    self.expect_op(")")
                    return Expr.call("steps", *conds)
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


def parse_filter_expression(text: str) -> FilterNode:
    """Parse a standalone boolean expression (the sub-filter strings of
    DISTINCTCOUNTTHETA)."""
    p = _Parser(text)
    node = p.boolean_expr()
    if p.cur.kind != "eof":
        p.fail("unexpected trailing input in filter expression")
    return node


def parse_query(sql: str) -> QueryContext:
    """Parse one SQL statement into a QueryContext (CalciteSqlParser analog)."""
    return _Parser(sql).parse()
