"""Multi-stage engine: star and snowflake joins over StackedTables on a
mesh of device positions.

Port of pinot_tpu/mse/engine.py.  Reference parity: the MSE runtime path
(QueryDispatcher shipping plan fragments to workers, leaf scans,
HashJoinOperator build and probe, Hash/BroadcastExchange mailboxes,
AggregateOperator and the broker's final reduce).

In the JAX package the whole multi-stage plan traces into one shard_map
program over the device mesh whose stage boundaries are collectives.  Here
it is one planned closure run once a mesh position (parallel/mesh.py) over
the flat rows of the position's shards of every table (position p holds
shards [p * L, (p + 1) * L) of each), its stages in the same order:

  leaf:      filter masks on the fact table and on every dimension
  exchange:  BROADCAST (every position's build rows gathered onto every
             position) or HASH (stable bucketing by key hash into
             fixed-capacity buckets, each position receiving its bucket of
             every source; mse/exchange.py)
  join:      sorted build side + searchsorted probe (mse/join.py)
  aggregate: the dense group-by through planner.grouped_partials, which on
             CUDA sends the computed int32 group key to the fused-scan
             kernel (ops/fused_scan.py), then the positions' partials fold
             as the distributed engine folds them (mesh.fold_partials)

The closure is a generator that yields at each exchange;
exchange.run_lockstep drives every position's generator through the
collectives in position order.  A mesh of one position is the JAX
package's one-device mesh: its collectives are the identity.

Scope, as in the JAX package: FROM fact JOIN dim ON fact.fk = dim.pk,
INNER or LEFT, aggregation or group-by on fact and dimension attributes;
build sides with non-unique keys up to a bounded multiplicity (the
range_join expansion, joinMaxDup, broadcast only, one such join a query);
snowflake chains (fact -> dim -> dim), self-joins through per-alias
facades, and join-output selection of bare columns.  Refused with the JAX
engine's errors: a shuffle with several joins, a chain through or to a
many-to-many side, cross-table WHERE predicates, a WHERE filter on a LEFT
JOIN's dimension, SELECT *, group-by expressions and pairwise-merge
aggregations.

A hash shuffle whose buckets overflow raises ExchangeOverflowError inside
the run; execute() re-plans with a doubled shuffleSlack (the slack is part
of the plan-cache key) up to shuffleSlackCap, counting each retry in
METRICS "mse.exchangeOverflowRetries".  Every query is recorded in the perf
ledger with engine="mse" and its analytic kernel cost.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.analysis.compile_audit import MSE_AUDIT
from pinot_tpu_torch.device import DeviceLike, resolve_device
from pinot_tpu_torch.mse import exchange as ex
from pinot_tpu_torch.mse.join import KEY_SENTINEL, lookup_join, range_join
from pinot_tpu_torch.mse.plan import JoinPlanError, ResolvedQuery, resolve
from pinot_tpu_torch.parallel import mesh as mesh_mod
from pinot_tpu_torch.parallel.engine import _ShardView, flatten_cols
from pinot_tpu_torch.query import executor, planner
from pinot_tpu_torch.query import reduce as reduce_mod
from pinot_tpu_torch.query.filter import FilterCompiler
from pinot_tpu_torch.query.ir import Expr, QueryContext
from pinot_tpu_torch.query.planner import GroupDim
from pinot_tpu_torch.query.result import (
    AggSegmentResult,
    DenseGroupData,
    ExecutionStats,
    GroupBySegmentResult,
    ResultTable,
    SelectionSegmentResult,
)
from pinot_tpu_torch.query.shape import column_info_from, params_structure, shape_digest
from pinot_tpu_torch.spi.schema import DataType
from pinot_tpu_torch.utils import perf
from pinot_tpu_torch.utils.cache import LruCache
from pinot_tpu_torch.utils.metrics import METRICS

__all__ = ["ExchangeOverflowError", "JoinPlanError", "MultiStageEngine"]

_INT_KEY_TYPES = (DataType.INT, DataType.LONG, DataType.TIMESTAMP, DataType.BOOLEAN)


def _order_pretrim(order_by, ord_cols, want: int, is_str: List[bool]):
    """Vectorized top-`want` row indices consistent with the reduce's sort
    (asc/desc, nulls placement, stable ties).  `is_str` comes from the
    DECLARED column types: numeric-looking strings rank lexicographically,
    like the final Python `<` comparator.  None when a column's values defy
    coding (the caller keeps every row for the full sort).  int64 order
    values round through float64 (ties beyond 2^53 may keep another of the
    rows the comparator deems equal)."""
    n = len(ord_cols[0])
    keys = []
    for ob, vals, s in zip(reversed(order_by), reversed(ord_cols), reversed(is_str)):
        a = np.asarray(vals, dtype=object)
        isnull = np.array([v is None for v in a], dtype=bool)
        body = a[~isnull]
        k = np.empty(n, dtype=np.float64)
        try:
            if s:
                # unique over the raw objects: Python `<` order, str and
                # bytes alike (astype(str) would rank bytes by their repr)
                _, inv = np.unique(body, return_inverse=True)
                num = inv.astype(np.float64)
            else:
                num = body.astype(np.float64)
            k[~isnull] = num if ob.ascending else -num
        except (ValueError, TypeError):
            return None
        k[isnull] = -np.inf if not ob.nulls_last else np.inf
        keys.append(k)
    return np.lexsort(tuple(keys))[:want]


def _max_multiplicity(dim_st, dcol) -> int:
    """Max repeats of one key in the build column (flat order = input order,
    padding at the tail)."""
    arr = dcol.codes if dcol.has_dictionary else dcol.values
    flat = np.asarray(arr).reshape(-1)[: dim_st.num_docs]
    if dcol.has_dictionary:
        counts = np.bincount(flat.astype(np.int64), minlength=dcol.dictionary.cardinality)
    else:
        _, counts = np.unique(flat, return_counts=True)
    return int(counts.max()) if len(counts) else 1


def _distinct_keys(dcol) -> int:
    return dcol.dictionary.cardinality if dcol.has_dictionary else dcol.stats.cardinality


def _int_key(cols, name: str, col) -> torch.Tensor:
    """int64 join-key values of an integer column: decoded through the
    dictionary tensor for a dictionary-coded column."""
    if col.has_dictionary:
        return cols[name]["dict"][cols[name]["codes"].to(torch.int64)].to(torch.int64)
    return cols[name]["values"].to(torch.int64)


@dataclass
class _JoinPlan:
    """Plan-time recipe for one join stage."""

    dim_table: str
    join_type: str
    fact_key: str
    dim_key: str
    build_key_fn: Callable  # (dim_cols) -> int64 keys
    probe_key_fn: Optional[Callable]  # (fact_cols, params) -> int64 keys (fact probes)
    attrs: List[str]  # dim columns gathered through the join
    # max build-key multiplicity (1 = unique PK join; >1 = bounded M:N
    # expansion through range_join)
    max_dup: int = 1
    # snowflake chain (probe key owned by an earlier-joined dim): index of
    # the parent join whose gathered value array supplies the probe keys
    parent: Optional[int] = None
    # parent columns gathered as int64 VALUES for child probes (chains)
    val_attrs: Optional[List[str]] = None
    # child-side translate param key (string chain keys: parent dict code ->
    # child build key space)
    trans_key: Optional[str] = None


@dataclass
class _MsePlan:
    kind: str  # "aggregation" | "groupby_dense" | "selection"
    # fn(fact_cols, dim_cols_list, params, dev): one position's generator
    # (exchange.run_lockstep) returning (out, overflow); overflow is the
    # shuffle's count of rows dropped over every position (out None when
    # > 0), else None
    fn: Callable
    params: Dict[str, Any]
    fact_needed: List[str]
    dim_needed: Dict[str, List[str]]
    aggs: List[Any]
    group_dims: List[GroupDim]
    num_groups: int
    strategy: str  # "broadcast" | "shuffle"
    rq: ResolvedQuery
    index_uses: Tuple = ()
    # selection: output columns, (table, join_type) per join in topological
    # order, the M:N expansion join index (host-side row assembly)
    select_columns: Optional[List[str]] = None
    joins_info: Optional[List[Tuple[str, str]]] = None
    dup_idx: Optional[int] = None
    # analytic kernel cost, made at the plan's first run and shared through
    # the plan cache
    cost: Optional[perf.KernelCost] = None
    # shuffle bucket slack the plan was built with (part of the plan-cache
    # key; the overflow back-pressure loop doubles it and re-plans)
    slack: float = 2.0
    # per params namespace ("fact", "dimf{i}"): the flat docs a position
    # holds (its "__boff__" is position * that) and the bitmap words laid
    # out [ndev, L, D // 32], of which a position takes its row
    position_docs: Optional[Dict[str, int]] = None
    row_sharded: Optional[Dict[str, frozenset]] = None


class ExchangeOverflowError(RuntimeError):
    """A hash exchange dropped rows (bucket capacity exceeded).  Carries the
    slack the failing plan ran with, so the back-pressure loop in execute()
    can re-plan with a doubled slack."""

    def __init__(self, overflow: int, slack: float):
        self.overflow = int(overflow)
        self.slack = float(slack)
        super().__init__(
            f"hash exchange dropped {self.overflow} rows at shuffleSlack="
            f"{self.slack} (bucket capacity exceeded)"
        )


class MultiStageEngine:
    """Join-capable engine over StackedTables on a mesh of device positions.

    mesh: a parallel.mesh.Mesh; None is one position on `device`, where None
    means CUDA and raises without it.  tables: a registry to share (the
    DistributedEngine passes its own).  residency: the device cache the
    tables' slices stage through (None: the table's plain cache)."""

    def __init__(self, device: DeviceLike = None, tables: Optional[Dict[str, Any]] = None, residency=None,
                 mesh: Optional[mesh_mod.Mesh] = None):
        if mesh is None:
            mesh = mesh_mod.Mesh([resolve_device(device)], (mesh_mod.SEG_AXIS,))
        elif device is not None:
            raise ValueError("pass a mesh or a device, not both")
        self.mesh = mesh
        self.positions: List[torch.device] = mesh.positions
        self.device = self.positions[0]
        self.tables: Dict[str, Any] = tables if tables is not None else {}
        self.residency = residency
        # plan-cache bytes charge the process host ledger the admission
        # controller tracks (cluster/admission.py)
        from pinot_tpu_torch.cluster.admission import process_host_budget

        self._plan_cache = LruCache(
            max_entries=planner._plan_cache_entries(), name="compile.mse", budget=process_host_budget()
        )
        # plan-cache misses (plans built) and hits since construction, and
        # the shape fingerprint of the last plan (the perf ledger's key)
        self.plan_misses = 0
        self.plan_hits = 0
        self._last_shape_fp = ""

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def register_table(self, name: str, stacked) -> None:
        if stacked.num_shards % self.num_devices:
            raise ValueError(f"num_shards={stacked.num_shards} not divisible by mesh size {self.num_devices}")
        self.tables[name] = stacked
        # drop stale self-join facades of a re-registered table
        for k in [k for k in self.tables if k.startswith(name + "@")]:
            del self.tables[k]

    def query(self, sql: str) -> ResultTable:
        from pinot_tpu_torch.sql.parser import parse_query

        return self.execute(parse_query(sql))

    # ------------------------------------------------------------------
    def execute(self, ctx: QueryContext) -> ResultTable:
        t0 = time.perf_counter()
        # overflow back-pressure: a shuffle plan whose buckets dropped rows
        # re-plans with a doubled slack (bounded by _backoff_slack) and runs
        # again; dropped rows never fold into partials, because an
        # overflowing run stops right after its exchange
        slack_override: Optional[float] = None
        while True:
            tp = time.perf_counter()
            misses = self.plan_misses
            plan = self._plan(ctx, slack=slack_override)
            cache_hit = self.plan_misses == misses
            rq = plan.rq
            fact_st = self.tables[rq.fact]
            stats = ExecutionStats(
                num_segments_queried=fact_st.num_shards,
                num_segments_processed=fact_st.num_shards,
                num_docs_scanned=fact_st.num_docs + sum(self.tables[j.table].num_docs for j in rq.joins),
                total_docs=fact_st.num_docs,
            )
            if not cache_hit:
                stats.compile_ms = (time.perf_counter() - tp) * 1000.0
            fact_cols = self._stage(fact_st, plan.fact_needed)
            dim_cols = [self._stage(self.tables[j.table], plan.dim_needed[j.table]) for j in rq.joins]
            stats.add_index_uses(plan.index_uses)
            params = self._position_params(plan)
            try:
                result = self._run(rq.ctx, plan, fact_cols, dim_cols, params, stats)
                break
            except ExchangeOverflowError as e:
                slack_override = self._backoff_slack(rq.ctx, e)
        out = reduce_mod.reduce_results(rq.ctx, [result], stats)
        out.stats.time_ms = (time.perf_counter() - t0) * 1000
        perf.PERF_LEDGER.record(
            rq.fact,
            shape_digest(self._last_shape_fp),
            rows=out.stats.num_docs_scanned,
            time_ms=out.stats.time_ms,
            kernel_bytes=out.stats.kernel_bytes,
            compile_ms=out.stats.compile_ms,
            cache_hit=cache_hit,
            engine="mse",
        )
        return out

    def _stage(self, stacked, names: List[str]) -> List[Dict[str, Any]]:
        """Each mesh position's shards of `names` on its device, flattened
        to [L * D] row tensors (unpacked codes, the dictionary tensor,
        values, nulls): the join reads every row of every table in one
        pass.  A list in position order."""
        L = stacked.num_shards // self.num_devices
        out = []
        for p, (dev, pid) in enumerate(zip(self.positions, self.mesh.position_ids)):
            cols, _ = stacked.to_device(dev, names, with_valid=False, residency=self.residency,
                                        shards=(p * L, (p + 1) * L), position=pid)
            out.append(flatten_cols(cols))
        return out

    def _position_params(self, plan: _MsePlan) -> List[Dict[str, Any]]:
        """Each position's params on its device: a namespace's "__boff__" is
        the position's first global flat doc (a host int), its bitmap words
        the position's row; the rest shared by the positions of a device."""
        shared: Dict[str, Dict[str, Any]] = {}
        out = []
        for p, dev in enumerate(self.positions):
            on_dev = shared.get(str(dev))
            if on_dev is None:
                on_dev = shared[str(dev)] = {
                    k: ({k2: executor._param_tensor(v2, dev) for k2, v2 in v.items()
                         if k2 != "__boff__" and k2 not in plan.row_sharded[k]} if isinstance(v, dict)
                        else executor._param_tensor(v, dev))
                    for k, v in plan.params.items()
                }
            params = {}
            for k, v in plan.params.items():
                if not isinstance(v, dict):
                    params[k] = on_dev[k]
                    continue
                ns = dict(on_dev[k])
                ns["__boff__"] = p * plan.position_docs[k]
                for k2 in plan.row_sharded[k]:
                    ns[k2] = executor._param_tensor(v[k2][p], dev)
                params[k] = ns
            out.append(params)
        return out

    # ------------------------------------------------------------------
    def _backoff_slack(self, ctx: QueryContext, err: ExchangeOverflowError) -> float:
        """Back-pressure response to a bucket overflow: double the slack,
        bounded by shuffleSlackCap (default ndev^2: at that slack every
        bucket can hold the whole row set, so a further overflow is a bug,
        not skew)."""
        ndev = self.num_devices
        cap = float(ctx.options.get("shuffleSlackCap", float(ndev * ndev)))
        if err.slack >= cap:
            raise RuntimeError(
                f"hash exchange still dropped {err.overflow} rows at "
                f"shuffleSlack={err.slack} (cap {cap}); raise the "
                "shuffleSlackCap query option if the key skew is expected"
            ) from err
        METRICS.counter("mse.exchangeOverflowRetries").inc()
        return min(err.slack * 2.0, cap)

    def _plan(self, ctx: QueryContext, slack: Optional[float] = None) -> _MsePlan:
        rq = resolve(ctx, self.tables)
        strategy = self._strategy(ctx, rq)
        if slack is None:
            slack = float(ctx.options.get("shuffleSlack", 2.0))
        if strategy != "shuffle":
            slack = 0.0  # broadcast plans never bucketize: one cache entry

        def _info(name: str):
            # column shapes resolve through the owning table; unknown
            # columns keep their literals in the key
            t = rq.owner.get(name)
            if t is None or t not in self.tables:
                return None
            return column_info_from(self.tables[t])(name)

        key = (
            rq.ctx.shape_fingerprint(_info),
            tuple(self.tables[t].signature() for t in [rq.fact] + [j.table for j in rq.joins]),
            strategy,
            self.num_devices,
            # the slack sets the bucket capacity the closure was built with,
            # so a retry at a doubled slack must miss here
            slack,
            planner.backend_tag(self.device),
        )
        self._last_shape_fp = key[0]
        cached = self._plan_cache.get(key)
        if cached is not None:
            # rebind the literals into a fresh plan around the cached
            # closure; a params-structure mismatch means the shape audit was
            # wrong for this query, and it plans anew
            plan = self._build_plan(rq, strategy, slack, cached_fn=cached.fn)
            if params_structure(plan.params) == params_structure(cached.params):
                plan.cost = cached.cost
                self.plan_hits += 1
                MSE_AUDIT.record_hit(key[0])
                return plan
        self.plan_misses += 1
        MSE_AUDIT.record_compile(key[0])
        plan = self._build_plan(rq, strategy, slack)
        self._plan_cache.put(key, plan)
        return plan

    def _strategy(self, ctx: QueryContext, rq: ResolvedQuery) -> str:
        opt = ctx.options.get("joinStrategy")
        if opt is not None and opt not in ("broadcast", "shuffle"):
            raise ValueError(f"unknown joinStrategy {opt!r} (expected 'broadcast' or 'shuffle')")
        if opt == "shuffle" and len(rq.joins) > 1:
            raise NotImplementedError(
                "hash-shuffle joins partition fact rows by one key; multi-join "
                "queries must use the broadcast strategy"
            )
        is_selection = not ctx.is_aggregate and not ctx.group_by
        chained = any(j.probe_owner and j.probe_owner != rq.fact for j in rq.joins)
        if chained or is_selection:
            # snowflake chains probe through gathered parent rows; selection
            # maps build rows back to host doc ids: both need every build
            # side whole (broadcast)
            if opt == "shuffle":
                raise NotImplementedError(
                    "snowflake chains and join-output selection require the "
                    "broadcast strategy (build rows must be globally addressable)"
                )
            return "broadcast"

        def _dup(j) -> bool:
            st = self.tables[j.table]
            return _distinct_keys(st.column(j.dim_key)) < st.num_docs

        # many-to-many build sides need the broadcast expansion path
        if any(_dup(j) for j in rq.joins):
            if opt == "shuffle":
                raise NotImplementedError(
                    "many-to-many joins ride the broadcast expansion; joinStrategy='shuffle' "
                    "requires unique build keys"
                )
            return "broadcast"
        if opt in ("broadcast", "shuffle"):
            return str(opt)
        if len(rq.joins) > 1:
            return "broadcast"
        # broadcast when every build side is small enough to replicate
        threshold = int(ctx.options.get("broadcastJoinRowThreshold", 1 << 22))
        if all(self.tables[j.table].num_docs <= threshold for j in rq.joins):
            return "broadcast"
        return "shuffle"

    # ------------------------------------------------------------------
    def _key_plan(self, idx: int, rq: ResolvedQuery, params: Dict[str, Any]) -> _JoinPlan:
        j = rq.joins[idx]
        probe_owner = j.probe_owner or rq.fact
        probe_st = self.tables[probe_owner]
        dim_st = self.tables[j.table]
        fcol = probe_st.column(j.fact_key)
        dcol = dim_st.column(j.dim_key)
        is_chain = probe_owner != rq.fact
        parent = (
            next(i for i, rj in enumerate(rq.joins[:idx]) if rj.table == probe_owner)
            if is_chain else None
        )

        max_dup = 1
        if _distinct_keys(dcol) < dim_st.num_docs:
            # many-to-many: bound the expansion by the true max multiplicity
            # (host-side, unfiltered: a safe static upper bound)
            max_dup = _max_multiplicity(dim_st, dcol)
            cap = int(rq.ctx.options.get("joinMaxDup", 64))
            if max_dup > cap:
                raise NotImplementedError(
                    f"join build side {j.table}.{j.dim_key} has keys repeated up to "
                    f"{max_dup}x; the static expansion is capped at joinMaxDup={cap} "
                    "(raise the option or pre-aggregate the build side)"
                )

        fname, dname = j.fact_key, j.dim_key
        trans_key = None
        probe_key = None
        if dcol.data_type.is_string_like or fcol.data_type.is_string_like:
            if not (dcol.has_dictionary and fcol.has_dictionary):
                raise NotImplementedError("string join keys require dictionaries on both sides")
            # probe dictionary code -> build dictionary code (the sentinel
            # where the value is missing from the build dictionary)
            dvals, fvals = dcol.dictionary.values, fcol.dictionary.values
            pos = np.searchsorted(dvals, fvals)
            posc = np.clip(pos, 0, max(0, len(dvals) - 1))
            ok = (dvals[posc] == fvals) if len(dvals) else np.zeros(len(fvals), bool)
            tkey = f"join{idx}.trans"
            params[tkey] = np.where(ok, posc, np.iinfo(np.int64).max).astype(np.int64)
            trans_key = tkey

            def build_key(dcols, _d=dname):
                return dcols[_d]["codes"].to(torch.int64)

            if not is_chain:

                def probe_key(fcols, p, _f=fname, _t=tkey):
                    return p[_t][fcols[_f]["codes"].to(torch.int64)]

        elif dcol.data_type in _INT_KEY_TYPES and fcol.data_type in _INT_KEY_TYPES:

            def build_key(dcols, _d=dname, _c=dcol):
                return _int_key(dcols, _d, _c)

            if not is_chain:

                def probe_key(fcols, p, _f=fname, _c=fcol):
                    return _int_key(fcols, _f, _c)

        else:
            raise NotImplementedError(
                f"join keys must be integer or string typed "
                f"(got {fcol.data_type.value} = {dcol.data_type.value})"
            )

        # null join keys never match (SQL equi-join semantics); a chain's
        # probe nulls fold in at the parent's value gather instead
        if probe_key is not None and fcol.nulls is not None:
            inner_probe = probe_key

            def probe_key(fcols, p, _f=fname, _inner=inner_probe):
                return torch.where(fcols[_f]["nulls"], KEY_SENTINEL, _inner(fcols, p))

        if dcol.nulls is not None:
            inner_build = build_key

            def build_key(dcols, _d=dname, _inner=inner_build):
                return torch.where(dcols[_d]["nulls"], KEY_SENTINEL, _inner(dcols))

        return _JoinPlan(
            j.table, j.join_type, fname, dname, build_key, probe_key,
            attrs=[], max_dup=max_dup, parent=parent, val_attrs=[], trans_key=trans_key,
        )

    def _dim_group_dim(self, expr: Expr, table: str, left_join: bool, null_handling: bool) -> Tuple[GroupDim, int]:
        """Returns (GroupDim, placeholder_code): placeholder_code >= 0 is the
        dictionary code of the SQL-NULL placeholder when a LEFT JOIN puts
        the null slot PAST the dictionary; the kernel remaps
        placeholder-coded rows onto that no-match slot, so the NULL group
        does not split in two."""
        c = self.tables[table].column(expr.op)
        if c.has_dictionary:
            card = c.dictionary.cardinality
            null_code = -1
            if c.nulls is not None and null_handling:
                nc = c.dictionary.index_of(c.data_type.null_placeholder)
                if nc >= 0:
                    null_code = nc
            if left_join:
                placeholder = null_code  # -1 when no null is stored
                return GroupDim(expr, c.name, "dict", card + 1, dictionary=c.dictionary, null_code=card), placeholder
            return GroupDim(expr, c.name, "dict", card, dictionary=c.dictionary, null_code=null_code), -1
        if c.data_type in _INT_KEY_TYPES and c.stats.min_value is not None:
            lo, hi = int(c.stats.min_value), int(c.stats.max_value)
            rng = hi - lo + 1
            if rng <= planner.MAX_DENSE_RAW_INT_RANGE:
                card, null_code = (rng + 1, rng) if left_join else (rng, -1)
                return GroupDim(expr, c.name, "rawint", card, base=lo, null_code=null_code), -1
        raise NotImplementedError(f"group-by on dimension column {expr.op} (type/range unsupported)")

    # ------------------------------------------------------------------
    def _build_plan(self, rq: ResolvedQuery, strategy: str, slack: float,
                    cached_fn: Optional[Callable] = None) -> _MsePlan:
        """Plan one join query.  With `cached_fn` (a plan-cache hit) the
        params and metadata are rebuilt around the cached closure."""
        ctx = rq.ctx
        ndev = self.num_devices
        fact_st = self.tables[rq.fact]
        fact_view = self._position_view(fact_st)
        local_rows = fact_view.num_docs
        null_handling = ctx.null_handling
        backend = planner.backend_tag(self.device)

        params: Dict[str, Any] = {}
        index_uses: List[Tuple[str, str]] = []
        fc_fact = FilterCompiler(fact_view, null_handling)
        fact_filter_fn = fc_fact.compile(rq.fact_filter)
        params["fact"] = fc_fact.params
        position_docs: Dict[str, int] = {"fact": local_rows}
        row_sharded: Dict[str, frozenset] = {}

        join_plans: List[_JoinPlan] = []
        dim_filter_fns: List[Callable] = []
        dim_used_columns: List[set] = []
        dim_docs: List[int] = []  # real (unpadded) rows per dimension
        for i, rj in enumerate(rq.joins):
            dim_st = self.tables[rj.table]
            dim_docs.append(dim_st.num_docs)
            dview = self._position_view(dim_st)
            fc = FilterCompiler(dview, null_handling)
            dim_filter_fns.append(fc.compile(rq.dim_filters[rj.table]))
            fc.params["__boff__"] = np.int32(0)
            params[f"dimf{i}"] = fc.params
            position_docs[f"dimf{i}"] = dview.num_docs
            row_sharded[f"dimf{i}"] = frozenset(fc.row_sharded_params)
            index_uses.extend(fc.index_uses)
            dim_used_columns.append(set(fc.used_columns))
            join_plans.append(self._key_plan(i, rq, params))

        # -- snowflake chains: parents gather probe-key VALUES -------------
        for jp in join_plans:
            if jp.parent is not None:
                pjp = join_plans[jp.parent]
                if pjp.max_dup > 1:
                    raise NotImplementedError(
                        f"snowflake chain through many-to-many join {pjp.dim_table!r} "
                        "is unsupported (pre-aggregate the M:N build side)"
                    )
                if jp.fact_key not in pjp.val_attrs:
                    pjp.val_attrs.append(jp.fact_key)
                if jp.max_dup > 1:
                    raise NotImplementedError("a many-to-many build side must join to the fact table directly")

        # -- aggregations (fact-side inputs only) ------------------------
        agg_specs = list(ctx.aggregations)
        for s in agg_specs:
            for col in ([] if s.expr is None else s.expr.columns()) + (
                s.filter.columns() if s.filter is not None else []
            ):
                if col != "*" and rq.owner[col] != rq.fact:
                    raise NotImplementedError(
                        f"aggregation input {col!r} belongs to joined table "
                        f"{rq.owner[col]!r}; only fact-table measures are supported"
                    )
        aggs = planner.bind_aggs(agg_specs, fact_st, ctx)
        agg_filter_fns = [fc_fact.compile(s.filter) if s.filter is not None else None for s in agg_specs]
        agg_inputs_fn = planner.make_agg_inputs(agg_specs, aggs, agg_filter_fns, fact_view, null_handling)
        index_uses.extend(fc_fact.index_uses)
        # a position's first global flat doc (exchange-time param, a host int)
        fc_fact.params["__boff__"] = np.int32(0)
        row_sharded["fact"] = frozenset(fc_fact.row_sharded_params)

        # -- group dimensions --------------------------------------------
        group_dims: List[GroupDim] = []
        dim_of_group: List[Optional[int]] = []  # join index, or None (fact)
        group_placeholder: List[int] = []  # LEFT JOIN placeholder remap code
        for g in ctx.group_by:
            if not g.is_column:
                raise NotImplementedError(f"group-by on expression {g} not yet supported")
            t = rq.owner[g.op]
            if t == rq.fact:
                group_dims.append(planner._group_dim(g, fact_view, null_handling))
                dim_of_group.append(None)
                group_placeholder.append(-1)
            else:
                ji = next(i for i, jp in enumerate(join_plans) if jp.dim_table == t)
                gd, placeholder = self._dim_group_dim(g, t, join_plans[ji].join_type == "left", null_handling)
                group_dims.append(gd)
                dim_of_group.append(ji)
                group_placeholder.append(placeholder)
                if g.op not in join_plans[ji].attrs:
                    join_plans[ji].attrs.append(g.op)

        select_columns: List[str] = []
        if ctx.is_aggregate and not ctx.group_by:
            kind = "aggregation"
            num_groups = 0
        elif ctx.group_by:
            kind = "groupby_dense"
            num_groups = 1
            for gd in group_dims:
                num_groups *= max(1, gd.cardinality)
            if num_groups > ctx.max_dense_groups:
                raise NotImplementedError(
                    f"join group-by key space {num_groups} exceeds maxDenseGroups "
                    f"({ctx.max_dense_groups}); high-cardinality join group-by is unsupported"
                )
        else:
            # join-output selection: the closure returns the match masks and
            # build-row indices, and the host gathers and decodes the
            # columns through them
            kind = "selection"
            num_groups = 0
            for s in ctx.select_list:
                if not (isinstance(s, Expr) and s.is_column):
                    raise NotImplementedError(f"join selection supports bare columns only (got {s})")
                if s.op == "*":
                    raise NotImplementedError("SELECT * over joins is unsupported; list columns")
                select_columns.append(s.op)
            for ob in ctx.order_by:
                if not ob.expr.is_column:
                    raise NotImplementedError("join selection ORDER BY supports bare columns only")

        planner.guard_sparse_vector_fields(kind, aggs)
        if any(fn.pairwise_merge for fn in aggs):
            raise NotImplementedError("pairwise-merge aggregations cannot ride the in-graph psum combine")
        vranges = planner.agg_vranges(agg_specs, fact_st)

        # -- needed columns ----------------------------------------------
        fact_needed: List[str] = []

        def need_fact(cols):
            for c in cols:
                if c != "*" and c not in fact_needed:
                    fact_needed.append(c)

        # filter-scanned columns come from the compiler's used set: columns
        # whose predicates resolved through an index never ship
        need_fact(sorted(fc_fact.used_columns))
        for s in agg_specs:
            if s.expr is not None:
                need_fact(s.expr.columns())
        for jp in join_plans:
            if jp.parent is None:  # chain probes read the PARENT DIM's rows
                need_fact([jp.fact_key])
        for g, di in zip(ctx.group_by, dim_of_group):
            if di is None:
                need_fact([g.op])
        dim_needed: Dict[str, List[str]] = {}
        for i, jp in enumerate(join_plans):
            cols = [jp.dim_key] + list(jp.attrs)
            cols += [a for a in jp.val_attrs if a not in cols]
            cols += [c for c in sorted(dim_used_columns[i]) if c not in cols]
            dim_needed[jp.dim_table] = cols

        # -- dim attribute arrays (codes for dict, raw values otherwise) --
        # raw values stay in their stored dtype until the base subtraction:
        # casting first would wrap values beyond int32 (the code after the
        # subtraction always fits, cardinality <= MAX_DENSE_RAW_INT_RANGE)
        tables = self.tables

        def attr_array(dcols, table: str, name: str):
            if tables[table].column(name).has_dictionary:
                return dcols[name]["codes"].to(torch.int32)
            return dcols[name]["values"]

        def val_array(dcols, table: str, name: str):
            """int64 probe-key VALUES of a parent-dim column for snowflake
            chains: dict codes for string keys (children translate), decoded
            values for ints; stored nulls become the never-match sentinel."""
            c = tables[table].column(name)
            if c.data_type.is_string_like:
                v = dcols[name]["codes"].to(torch.int64)
            else:
                v = _int_key(dcols, name, c)
            if c.nulls is not None:
                v = torch.where(dcols[name]["nulls"], KEY_SENTINEL, v)
            return v

        def group_code(gd: GroupDim, arr):
            if gd.kind == "rawint":
                return (arr - gd.base).to(torch.int32)  # subtract in the stored dtype
            return arr

        def fact_group_code(gd: GroupDim, fcols):
            if gd.kind == "dict":
                return fcols[gd.name]["codes"].to(torch.int32)
            return (fcols[gd.name]["values"] - gd.base).to(torch.int32)

        # bounded M:N expansion (at most one non-unique build side)
        dup_idxs = [i for i, jp in enumerate(join_plans) if jp.max_dup > 1]
        if len(dup_idxs) > 1:
            raise NotImplementedError(
                "at most one join may have a many-to-many build side "
                f"(got {len(dup_idxs)}); pre-aggregate the other build sides"
            )
        dup_idx = dup_idxs[0] if dup_idxs else None
        if dup_idx is not None and strategy != "broadcast":
            raise NotImplementedError("many-to-many joins require the broadcast strategy")
        fact_docs = fact_st.num_docs

        def valid_rows(mask, real_rows: int, base: int, dev):
            """Padding rows (the tail of the global flat doc order) of the
            position whose first doc is `base` masked off."""
            if base + mask.shape[0] > real_rows:
                return mask & (torch.arange(mask.shape[0], dtype=torch.int32, device=dev) < real_rows - base)
            return mask

        # ------------------------------------------------------------------
        def kernel(fcols, dim_cols_list, params, dev):
            fmask, _ = fact_filter_fn(fcols, params["fact"], dev)
            fmask = valid_rows(fmask, fact_docs, params["fact"]["__boff__"], dev)
            overflow = None

            def dim_leaf(i):
                dcols = dim_cols_list[i]
                dmask, _ = dim_filter_fns[i](dcols, params[f"dimf{i}"], dev)
                return dcols, valid_rows(dmask, dim_docs[i], params[f"dimf{i}"]["__boff__"], dev)

            # leaf + exchange + probe per join (topological order: snowflake
            # parents run before their children)
            gathered: Dict[Tuple[int, str], Any] = {}
            gathered_vals: Dict[Tuple[int, str], Any] = {}  # chain probe keys
            matches: List[Any] = []
            brows: List[Any] = []

            if strategy == "broadcast":
                probe_cols = fcols
                probe_mask = fmask
                for i, jp in enumerate(join_plans):
                    dcols, dmask = dim_leaf(i)
                    side = {"key": jp.build_key_fn(dcols), "ok": dmask}
                    for a in jp.attrs:
                        side[a] = attr_array(dcols, jp.dim_table, a)
                    for a in jp.val_attrs:
                        side["__val__" + a] = val_array(dcols, jp.dim_table, a)
                    g = yield ("broadcast", side)  # every position's build rows, in mesh order
                    if jp.parent is None:
                        pk = jp.probe_key_fn(fcols, params)
                    else:
                        # chain probe: the parent's gathered value per fact row
                        pv = gathered_vals[(jp.parent, jp.fact_key)]
                        if jp.trans_key is not None:
                            t = params[jp.trans_key]
                            idx = torch.clamp(pv, 0, t.shape[0] - 1)
                            pk = torch.where(pv == KEY_SENTINEL, KEY_SENTINEL, t[idx])
                        else:
                            pk = pv
                    if i == dup_idx:
                        # bounded M:N: the [P, max_dup] expansion; validity
                        # folds into exp_mask below, not into probe_mask
                        brow, match = range_join(g["key"], g["ok"], pk, jp.max_dup)
                        matches.append(match)
                    else:
                        brow, match = lookup_join(g["key"], g["ok"], pk)
                        matches.append(match)
                        if jp.join_type == "inner":
                            probe_mask = probe_mask & match
                    brows.append(brow)
                    for a in jp.attrs:
                        gathered[(i, a)] = g[a][brow]
                    for a in jp.val_attrs:
                        gathered_vals[(i, a)] = torch.where(match, g["__val__" + a][brow], KEY_SENTINEL)
            else:  # hash shuffle: one join (_strategy), unique build keys
                # fact payload: the probe key, fact group codes, and each
                # distinct aggregation value and mask tensor once
                payload: Dict[str, Any] = {"k0": join_plans[0].probe_key_fn(fcols, params)}
                for gi, (gd, di) in enumerate(zip(group_dims, dim_of_group)):
                    if di is None:
                        payload[f"g{gi}"] = fact_group_code(gd, fcols)
                inputs = agg_inputs_fn(fcols, params["fact"], fmask, dev)
                shipped: Dict[int, Optional[str]] = {id(fmask): None}  # fmask arrives as the probe mask

                def ship(t):
                    if id(t) not in shipped:
                        shipped[id(t)] = f"p{len(shipped)}"
                        payload[shipped[id(t)]] = t
                    return shipped[id(t)]

                names = [(ship(v), ship(m)) for v, m in inputs]
                dest = ex.hash_dest(payload["k0"], ndev)
                cap_f = max(1, int(-(-local_rows // ndev) * slack))
                recv, rvalid, ovf = yield ("shuffle", payload, dest, fmask, ndev, cap_f)
                overflow = ovf
                probe_cols = recv
                probe_mask = rvalid

                jp = join_plans[0]
                dcols, dmask = dim_leaf(0)
                dkey = jp.build_key_fn(dcols)
                side = {"key": dkey}
                for a in jp.attrs:
                    side[a] = attr_array(dcols, jp.dim_table, a)
                cap_d = max(1, int(-(-dkey.shape[0] // ndev) * slack))
                drecv, dvalid_r, dovf = yield ("shuffle", side, ex.hash_dest(dkey, ndev), dmask, ndev, cap_d)
                # dropped rows must never fold into partials: an overflowing
                # run stops here (no join, no scan) and execute() re-plans
                overflow = int(overflow + dovf)
                if overflow:
                    return None, overflow
                brow, match = lookup_join(drecv["key"], dvalid_r, recv["k0"])
                matches.append(match)
                if jp.join_type == "inner":
                    probe_mask = probe_mask & match
                for a in jp.attrs:
                    gathered[(0, a)] = drecv[a][brow]

            # -- M:N expansion mask ([P, D] slot validity) -----------------
            exp_mask = None
            if dup_idx is not None:
                m2 = matches[dup_idx]
                if join_plans[dup_idx].join_type == "left":
                    # LEFT with zero matches: one surviving slot (0)
                    # carrying the null dim code
                    nomatch = ~m2.any(dim=1)
                    slot0 = torch.arange(m2.shape[1], device=dev) == 0
                    m2 = m2 | (nomatch[:, None] & slot0[None, :])
                exp_mask = probe_mask[:, None] & m2

            def _expand_rows(v):
                """[P] row tensor -> flat [P * D] under the expansion."""
                return v[:, None].expand(exp_mask.shape).reshape(-1)

            # -- selection: the match mask and build-row indices only -------
            if kind == "selection":
                out = {"mask": probe_mask}
                for i in range(len(join_plans)):
                    out[f"brow{i}"] = brows[i].to(torch.int32)
                    out[f"match{i}"] = matches[i]
                if exp_mask is not None:
                    out["exp"] = exp_mask
                return out, overflow

            # -- aggregate ------------------------------------------------
            if strategy == "broadcast":
                inputs = agg_inputs_fn(fcols, params["fact"], probe_mask, dev)
            else:
                def _recv(name):
                    return probe_mask if name is None else probe_cols[name]

                inputs = [(_recv(v), _recv(m) if m is None else _recv(m) & probe_mask) for v, m in names]
            if exp_mask is not None:
                flat_exp = exp_mask.reshape(-1)
                expanded: Dict[int, Any] = {id(probe_mask): flat_exp}

                def _exp(t, is_mask):
                    if id(t) not in expanded:
                        e = _expand_rows(t)
                        expanded[id(t)] = e & flat_exp if is_mask else e
                    return expanded[id(t)]

                inputs = [(_exp(v, False), _exp(m, True)) for v, m in inputs]
                tmask = flat_exp
            else:
                tmask = probe_mask

            if kind == "aggregation":
                return [fn.partial(v, m) for fn, (v, m) in zip(aggs, inputs)], overflow

            # group key assembly: the computed int32 key of every dimension
            key = None
            for gi, (gd, di) in enumerate(zip(group_dims, dim_of_group)):
                if di is None:
                    code = fact_group_code(gd, fcols) if strategy == "broadcast" else probe_cols[f"g{gi}"]
                    if exp_mask is not None:
                        code = _expand_rows(code)
                else:
                    code = group_code(gd, gathered[(di, gd.expr.op)])
                    match = matches[di]
                    if join_plans[di].join_type == "left":
                        code = torch.where(match, code, gd.null_code)
                        # the stored-NULL placeholder joins the no-match NULL slot
                        ph = group_placeholder[gi]
                        if ph >= 0:
                            code = torch.where(code == ph, gd.null_code, code)
                    else:
                        code = torch.where(match, code, 0)
                    if exp_mask is not None:
                        code = code.reshape(-1) if di == dup_idx else _expand_rows(code)
                code = torch.clamp(code, 0, gd.cardinality - 1)
                key = code if key is None else key * gd.cardinality + code
            return planner.grouped_partials(
                aggs, inputs, tmask, lambda: key, num_groups, vranges, backend=backend,
            ), overflow

        return _MsePlan(
            kind=kind,
            fn=cached_fn if cached_fn is not None else kernel,
            params=params,
            fact_needed=fact_needed,
            dim_needed=dim_needed,
            aggs=aggs,
            group_dims=group_dims,
            num_groups=num_groups,
            strategy=strategy,
            rq=rq,
            index_uses=tuple(index_uses),
            select_columns=select_columns,
            joins_info=[(jp.dim_table, jp.join_type) for jp in join_plans],
            dup_idx=dup_idx,
            slack=slack,
            position_docs=position_docs,
            row_sharded=row_sharded,
        )

    def _position_view(self, stacked) -> _ShardView:
        """Plan-time facade of one mesh position's rows of `stacked` (L
        shards x D): bitmap words laid out [ndev, L, D // 32], and sorted
        doc ranges compared against global flat doc ids (the namespace's
        "__boff__" param)."""
        ndev = self.num_devices
        L = stacked.num_shards // ndev
        rows = L * stacked.docs_per_shard

        def docs_fn(params, dev):
            return params["__boff__"] + torch.arange(rows, dtype=torch.int32, device=dev)

        return _ShardView(stacked, rows, docs_fn=docs_fn, bitmap_layout=(ndev, L, stacked.docs_per_shard // 32))

    # ------------------------------------------------------------------
    def _run(self, ctx, plan: _MsePlan, fact_cols, dim_cols, params, stats: ExecutionStats):
        if plan.cost is None:
            # the fact-side scan dominates the bytes; build sides are small
            # by strategy, so the analytic model reads the fact columns only
            fact_st = self.tables[plan.rq.fact]
            plan.cost = perf.analytic_cost(
                fact_st.num_docs,
                perf.analytic_bytes_per_row(fact_st.column(n) for n in plan.fact_needed),
                kind=plan.kind,
                num_groups=plan.num_groups,
                num_entries=len(plan.aggs) if plan.aggs else 1,
            )
        td0 = time.perf_counter()
        outs = ex.run_lockstep([
            plan.fn(fact_cols[p], [dc[p] for dc in dim_cols], params[p], dev)
            for p, dev in enumerate(self.positions)
        ])
        overflow = outs[0][1]
        if overflow:
            # execute()'s back-pressure loop catches this, doubles the slack
            # (bounded by shuffleSlackCap) and re-plans
            raise ExchangeOverflowError(overflow, plan.slack)
        stats.kernel_bytes += plan.cost.bytes_accessed
        stats.kernel_flops += plan.cost.flops
        stats.kernel_cost_source = plan.cost.source
        outs = [o for o, _ in outs]
        shape = self.mesh.shape
        if plan.kind == "aggregation":
            host = executor._to_host(mesh_mod.fold_partials(plan.aggs, outs, shape))
            stats.device_ms += (time.perf_counter() - td0) * 1000.0
            return AggSegmentResult(partials=[fn.host_partial(p) for fn, p in zip(plan.aggs, host)])
        if plan.kind == "selection":
            # every position's rows in mesh order: the global fact order
            # (build-row indices already address the gathered global order)
            sel = executor._to_host(outs[0] if len(outs) == 1 else {
                k: torch.cat([mesh_mod.to_home(o[k], self.device) for o in outs]) for k in outs[0]})
            stats.device_ms += (time.perf_counter() - td0) * 1000.0
            stats.bytes_to_host += sum(int(a.nbytes) for a in sel.values())
            return self._gather_join_selection(ctx, plan, sel)
        presence = mesh_mod.psum_hierarchical([pr for pr, _ in outs], shape)
        presence, partials = executor._to_host(
            (presence, mesh_mod.fold_partials(plan.aggs, [q for _, q in outs], shape)))
        stats.device_ms += (time.perf_counter() - td0) * 1000.0
        shim = SimpleNamespace(group_dims=plan.group_dims, aggs=plan.aggs)
        dense = DenseGroupData(
            presence=presence,
            partials=partials,
            key_space=executor._key_space_id(shim),
            group_dims=plan.group_dims,
        )
        keys, sliced = executor._dense_to_present(
            shim, presence, partials, ctx.num_groups_limit,
            order_trim=planner.order_by_agg_index(ctx),
        )
        stats.num_groups = len(keys[0]) if keys else 0
        return GroupBySegmentResult(keys=keys, partials=sliced, dense=dense)

    # ------------------------------------------------------------------
    def _gather_join_selection(self, ctx, plan: _MsePlan, sel) -> SelectionSegmentResult:
        """Join-output selection rows (HashJoinOperator output semantics):
        the closure returned the fact row mask, and per join the build-row
        indices (flat dim order) and the match mask; columns decode on the
        host through them.  A LEFT JOIN's unmatched rows give SQL NULL dim
        values."""
        rq = plan.rq
        fact_st = self.tables[rq.fact]
        mask = np.asarray(sel["mask"]).reshape(-1)
        exp = np.asarray(sel["exp"]) if "exp" in sel else None
        if exp is not None:
            frow, slot = np.nonzero(exp)
        else:
            frow = np.nonzero(mask)[0]
            slot = None
        want = ctx.offset + ctx.limit

        def col_out(name: str, rows: np.ndarray, slots) -> np.ndarray:
            t = rq.owner[name]
            if t == rq.fact:
                c = fact_st.column(name)
                vals = fact_st.decoded_rows(name, rows)
                if c.nulls is not None and ctx.null_handling:
                    vals = np.asarray(vals, dtype=object)
                    vals[c.nulls.reshape(-1)[rows]] = None
                return vals
            ji = next(i for i, (tb, _) in enumerate(plan.joins_info) if tb == t)
            st = self.tables[t]
            if ji == plan.dup_idx:
                br = np.asarray(sel[f"brow{ji}"])[rows, slots]
                mt = np.asarray(sel[f"match{ji}"])[rows, slots]
            else:
                br = np.asarray(sel[f"brow{ji}"])[rows]
                mt = np.asarray(sel[f"match{ji}"])[rows]
            total = st.num_shards * st.docs_per_shard
            safe = np.clip(br, 0, max(0, total - 1))
            c = st.column(name)
            vals = np.asarray(st.decoded_rows(name, safe), dtype=object)
            if c.nulls is not None and ctx.null_handling:
                vals[c.nulls.reshape(-1)[safe]] = None
            vals[~mt] = None  # LEFT no-match: SQL NULL (inner rows always match)
            return vals

        if not ctx.order_by and len(frow) > want:
            frow = frow[:want]
            slot = slot[:want] if slot is not None else None
        elif ctx.order_by and len(frow) > want:
            # the top `want` rows under the reduce's comparator, so only a
            # LIMIT-sized set materializes as object arrays
            def _col_type(name: str):
                t = rq.owner[name]
                st = fact_st if t == rq.fact else self.tables[t]
                return st.column(name).data_type

            ord_cols = [col_out(ob.expr.op, frow, slot) for ob in ctx.order_by]
            is_str = [_col_type(ob.expr.op).is_string_like for ob in ctx.order_by]
            keep = _order_pretrim(ctx.order_by, ord_cols, want, is_str)
            if keep is not None:
                frow = frow[keep]
                slot = slot[keep] if slot is not None else None

        arrays: Dict[str, np.ndarray] = {}
        for name in plan.select_columns:
            arrays[name] = col_out(name, frow, slot)
        for i, ob in enumerate(ctx.order_by):
            arrays[f"__ord{i}"] = col_out(ob.expr.op, frow, slot)
        cols_out = plan.select_columns + [f"__ord{i}" for i in range(len(ctx.order_by))]
        return SelectionSegmentResult(columns=cols_out, arrays=arrays)
