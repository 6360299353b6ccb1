"""MSE logical planning: resolve joined tables, split filters, rewrite refs.

Port of pinot_tpu/mse/plan.py.  Reference parity: the front half of
pinot-query-planner (QueryEnvironment's Calcite pipeline resolving table and
column references and pushing filters below the join).

No Calcite: the star-join shape (one fact table, N dimension tables joined
on fact FK = dim PK, snowflake chains through an earlier dimension) is
resolved directly.  Qualified names are stripped to plain column names,
every reference gets an owning table, self-joins get per-alias facades
(StackedTable.aliased_view), and WHERE conjuncts are pushed to the one table
they touch.  The static plan check (analysis/plan_check.check_plan) runs
first, as in the JAX package: a malformed query raises PlanCheckError
before any launch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pinot_tpu_torch.query.ir import (
    AggregationSpec,
    Expr,
    ExprKind,
    FilterNode,
    FilterOp,
    JoinClause,
    OrderByExpr,
    QueryContext,
    map_expr_columns as _map_expr,
    map_filter_columns as _map_filter,
)


class JoinPlanError(ValueError):
    pass


@dataclass
class ResolvedJoin:
    table: str  # physical dimension (build-side) table name
    join_type: str  # "inner" | "left"
    fact_key: str  # plain probe-side column name (fact OR parent dim)
    dim_key: str  # plain dim column name (build side)
    # which table owns the probe key: the fact table (star) or an
    # earlier-joined dimension (snowflake chain — LookupJoinOperator's
    # dim->dim analog); joins are topologically ordered so the parent's
    # gathered rows exist before this join probes through them
    probe_owner: str = ""


@dataclass
class ResolvedQuery:
    ctx: QueryContext  # rewritten: plain column names everywhere
    fact: str
    joins: List[ResolvedJoin]
    owner: Dict[str, str]  # plain column name -> owning table
    fact_filter: Optional[FilterNode]
    dim_filters: Dict[str, Optional[FilterNode]] = field(default_factory=dict)


def resolve(ctx: QueryContext, schemas: Dict[str, "object"]) -> ResolvedQuery:
    """schemas: table name -> object with .column_names (Schema/StackedTable)."""
    # schema-free static validation (function existence/arity, agg nesting,
    # limit sanity) before join resolution; column ownership is checked by
    # resolve_name below against the per-table column sets
    from pinot_tpu_torch.analysis.plan_check import check_plan

    check_plan(ctx)
    fact = ctx.table
    if fact not in schemas:
        raise JoinPlanError(f"table {fact!r} is not registered")

    # -- self-joins: duplicate physical tables get per-ALIAS facades -------
    # (columns renamed '{alias}${col}', storage shared — StackedTable
    # .aliased_view; the reference disambiguates in Calcite scope binding)
    phys = [fact] + [j.table for j in ctx.joins]
    dup_phys = {t for t in phys if phys.count(t) > 1}
    joins_in: List[JoinClause] = list(ctx.joins)
    alias_prefix: Dict[str, str] = {}  # facade table name -> column prefix
    if dup_phys:
        rewritten: List[JoinClause] = []
        for j in ctx.joins:
            if j.table in dup_phys:
                if not j.alias:
                    raise JoinPlanError(
                        f"self-join on {j.table!r} requires an alias for each occurrence"
                    )
                fname = f"{j.table}@{j.alias}"
                if fname not in schemas:
                    base = schemas[j.table]
                    if not hasattr(base, "aliased_view"):
                        raise JoinPlanError(
                            f"self-join on {j.table!r} requires StackedTable registration"
                        )
                    schemas[fname] = base.aliased_view(j.alias)
                alias_prefix[fname] = j.alias
                rewritten.append(dataclasses.replace(j, table=fname))
            else:
                rewritten.append(j)
        joins_in = rewritten

    alias_map: Dict[str, str] = {ctx.table_alias or fact: fact, fact: fact}
    tables: List[str] = [fact]
    for j in joins_in:
        if j.table not in schemas:
            raise JoinPlanError(f"joined table {j.table!r} is not registered")
        if j.table in tables:
            raise JoinPlanError(
                f"table {j.table!r} joined twice; alias each occurrence of a self-join"
            )
        tables.append(j.table)
        alias_map[j.alias or j.table] = j.table
        alias_map.setdefault(j.table, j.table)

    col_sets = {t: set(schemas[t].column_names) for t in tables}

    def resolve_name(name: str) -> "tuple[str, str]":
        if name == "*":
            return name, fact
        if "." in name:
            q, c = name.split(".", 1)
            t = alias_map.get(q)
            if t is None:
                raise JoinPlanError(f"unknown table alias {q!r} in {name!r}")
            if c not in col_sets[t]:
                pc = f"{alias_prefix[t]}${c}" if t in alias_prefix else None
                if pc is not None and pc in col_sets[t]:
                    return pc, t
                raise JoinPlanError(f"table {t!r} has no column {c!r}")
            return c, t
        owners = [t for t in tables if name in col_sets[t]]
        if not owners:
            raise JoinPlanError(f"unknown column {name!r}")
        if len(owners) > 1:
            raise JoinPlanError(
                f"column {name!r} exists in {owners}; qualify it (alias.column)"
            )
        return name, owners[0]

    owner: Dict[str, str] = {}

    def note(plain: str, t: str) -> None:
        prev = owner.setdefault(plain, t)
        if prev != t:
            raise JoinPlanError(
                f"column name {plain!r} resolves to both {prev!r} and {t!r}; "
                "identically-named columns across joined tables are unsupported"
            )

    def rewrite_col(e: Expr) -> Expr:
        plain, t = resolve_name(e.op)
        note(plain, t) if plain != "*" else None
        return e if e.op == plain else Expr.col(plain)

    def rw_expr(e: Expr) -> Expr:
        return _map_expr(e, rewrite_col)

    def rw_agg(s: AggregationSpec) -> AggregationSpec:
        return dataclasses.replace(
            s,
            expr=rw_expr(s.expr) if s.expr is not None else None,
            filter=_map_filter(s.filter, rewrite_col),
        )

    select_list = [rw_agg(s) if isinstance(s, AggregationSpec) else rw_expr(s) for s in ctx.select_list]
    group_by = [rw_expr(g) for g in ctx.group_by]
    where = _map_filter(ctx.filter, rewrite_col)
    having = _map_filter(ctx.having, rewrite_col)
    order_by = [OrderByExpr(rw_expr(o.expr), o.ascending, o.nulls_last) for o in ctx.order_by]
    extra_aggs = [rw_agg(s) for s in ctx.extra_aggregations]

    joins: List[ResolvedJoin] = []
    for j in joins_in:
        lk, lt = resolve_name(j.left_key.op)
        rk, rt = resolve_name(j.right_key.op)
        note(lk, lt)
        note(rk, rt)
        # normalize orientation: fact (or any non-this-dim) side is the probe
        if rt == j.table and lt != j.table:
            fact_key, fk_owner, dim_key = lk, lt, rk
        elif lt == j.table and rt != j.table:
            fact_key, fk_owner, dim_key = rk, rt, lk
        else:
            raise JoinPlanError(
                f"JOIN ON for {j.table!r} must link it to another table "
                f"(got {j.left_key} = {j.right_key})"
            )
        joins.append(ResolvedJoin(j.table, j.join_type, fact_key, dim_key, probe_owner=fk_owner))

    # -- topological order: snowflake parents before their children --------
    # (dim->dim chains probe through the PARENT's gathered rows; a chain's
    # probe owner must itself be joined before the child runs)
    ordered: List[ResolvedJoin] = []
    pending = list(joins)
    placed = {fact}
    while pending:
        progressed = False
        for j in list(pending):
            if j.probe_owner in placed:
                ordered.append(j)
                placed.add(j.table)
                pending.remove(j)
                progressed = True
        if not progressed:
            cyc = [(j.table, j.probe_owner) for j in pending]
            raise JoinPlanError(
                f"join graph is not a tree rooted at {fact!r}: {cyc} "
                "(each join's probe key must reference the fact table or an "
                "earlier-joined dimension)"
            )
    joins = ordered

    # -- filter pushdown: split top-level AND conjuncts by owning table ----
    fact_filter: Optional[FilterNode] = None
    dim_filters: Dict[str, Optional[FilterNode]] = {j.table: None for j in joins}

    def conjuncts(node: Optional[FilterNode]) -> List[FilterNode]:
        if node is None:
            return []
        if node.op is FilterOp.AND:
            out: List[FilterNode] = []
            for c in node.children:
                out.extend(conjuncts(c))
            return out
        return [node]

    per_table: Dict[str, List[FilterNode]] = {t: [] for t in tables}
    for c in conjuncts(where):
        touched = {owner[col] for col in c.columns() if col != "*"}
        if len(touched) > 1:
            raise JoinPlanError(
                f"WHERE predicate {c.predicates()} spans tables {sorted(touched)}; "
                "cross-table predicates (non-equi join conditions) are unsupported"
            )
        t = next(iter(touched)) if touched else fact
        per_table[t].append(c)

    def combine(nodes: List[FilterNode]) -> Optional[FilterNode]:
        if not nodes:
            return None
        if len(nodes) == 1:
            return nodes[0]
        return FilterNode.and_(*nodes)

    fact_filter = combine(per_table[fact])
    for j in joins:
        dim_filters[j.table] = combine(per_table[j.table])
        if j.join_type == "left" and dim_filters[j.table] is not None:
            # a WHERE filter on the dim side of a LEFT JOIN would silently
            # change semantics (NULL rows fail predicates) — the reference
            # keeps such filters above the join; we reject for now
            raise JoinPlanError(
                f"WHERE filter on LEFT JOIN dimension {j.table!r} is unsupported "
                "(it would not preserve unmatched rows)"
            )

    ctx2 = dataclasses.replace(
        ctx,
        select_list=select_list,
        group_by=group_by,
        filter=where,
        having=having,
        order_by=order_by,
        extra_aggregations=extra_aggs,
        joins=list(ctx.joins),
    )
    return ResolvedQuery(
        ctx=ctx2,
        fact=fact,
        joins=joins,
        owner=owner,
        fact_filter=fact_filter,
        dim_filters=dim_filters,
    )
