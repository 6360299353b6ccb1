"""Aggregation function registry.

Port of pinot_tpu/query/functions.py: the ten core functions (COUNT, SUM,
MIN, MAX, AVG, MINMAXRANGE, VARIANCE/VARSAMP, STDDEV/STDDEVSAMP) with their
partials on torch tensors and merge/final on host numpy, plus the hooks the
sketch and extended families use (literal arguments, column binding, reduce
binding, host partials, extra expressions, sub-filters, pairwise merges).
Those families register from query/sketches.py, query/aggs_extra.py and
query/aggs_stats.py, imported at the bottom in the JAX package's order.
The multi-value forms (*MV) register from query/aggs_extra.py.

Reference parity: pinot-core AggregationFunction contract
(.../query/aggregation/function/AggregationFunction.java:44 — aggregate /
aggregateGroupBySV / merge / extractFinalResult) and
AggregationFunctionFactory.

Re-design: the per-row `aggregate` loop becomes two vectorized device forms —
`partial(values, mask)` (scalar partial over a whole segment) and
`partial_grouped(values, mask, keys, num_groups)` (dense group table via
index_add/scatter-min — the DefaultGroupByExecutor + result-holder analog).
Partials are dicts of arrays so merge is shape-generic: AVG carries
(sum, count), MIN carries (min, seen), etc.  All numeric aggregation is
float64, matching Pinot's double accumulators (SumAggregationFunction et al).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from pinot_tpu_torch.ops import segmented as ops

Partial = Dict[str, Any]

_POS_INF = float("inf")
_NEG_INF = float("-inf")

# CONTRACT: partial field NAMES imply their combine semantics.  Generic code
# (aligned dense merges, the vectorized hash merge) dispatches on the field
# name instead of calling per-function merge() pairwise.
#   sum/count/sumsq -> additive      min -> minimum      max -> maximum
FIELD_COMBINE = {
    "sum": "add",
    "count": "add",
    "sumsq": "add",
    "min": "min",
    "max": "max",
    # sketch fields (query/sketches.py): presence bitmaps and HLL registers
    # union via max; histograms add; bin-range bookkeeping via min/max
    "present": "max",
    "hll": "max",
    "hist": "add",
    "lo": "min",
    "hi": "max",
    # covariance tuple fields (query/aggs_stats.py) — all additive
    "sumx": "add",
    "sumy": "add",
    "sumxy": "add",
    "sumsqx": "add",
    "sumsqy": "add",
}


def field_identity(field_name: str) -> float:
    op = FIELD_COMBINE[field_name]
    return 0.0 if op == "add" else (_POS_INF if op == "min" else _NEG_INF)


def combine_field(field_name: str, a, b):
    """Combine two partial fields by their name's semantics: numpy arrays
    on the host, torch tensors on their device."""
    op = FIELD_COMBINE[field_name]
    if op == "add":
        return a + b
    if isinstance(a, torch.Tensor):
        return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)
    if op == "min":
        return np.minimum(a, b)
    return np.maximum(a, b)


class AggFunction:
    """Base: one aggregation function's device/host contract."""

    name: str = ""
    # an argument expression is required (the plan check reads it)
    needs_expr: bool = True
    # static partial field names (keys of partial()/partial_grouped() output)
    fields: tuple = ()
    # the planner feeds dictionary codes / range-offset ints instead of values
    needs_codes: bool = False
    # the planner must call bind_column() with per-column constants first
    needs_binding: bool = False
    # partial fields are per-group VECTORS (presence/registers/histograms)
    vector_fields: bool = False
    # partials merge ONLY via pairwise fn.merge (coupled fields, e.g.
    # LASTWITHTIME's (t, v) or theta's KMV set): the field-name elementwise
    # combines must not touch them
    pairwise_merge: bool = False
    # spec.extra_exprs evaluate alongside expr; partial() receives the tuple
    # (values, extra0, ...) instead of a single array
    needs_extra_exprs: bool = False
    # theta sub-filter set expressions: partial() receives (values, mask_1, ...)
    subfilter_args: bool = False
    # multi-value element aggregation (*MV): partial() receives the padded
    # [rows, max_len] element matrix and mask (planner.mv_agg_input)
    mv_input: bool = False
    # how a needs_codes function's input is fed: "codes" | "values_offset" |
    # "values_hash" (planner.agg_input_codes)
    input_kind: str = "codes"
    # field -> entry kind ("count"|"sum"|"sumsq"|"min"|"max") for the fused
    # dense group-by scan (ops.fused_group_tables); None = the function's own
    # partial_grouped runs instead (sketch family)
    field_kinds = None

    # -- binding (sketch functions override; see query/sketches.py) ------
    def with_args(self, literal_args) -> "AggFunction":
        """Specialize with SQL literal arguments (percentile rank, log2m)."""
        return self

    def bind_column(self, info) -> "AggFunction":
        """Bind per-column constants (domain, hash tables, bin ranges)."""
        return self

    def bind_reduce(self, ctx, spec) -> "AggFunction":
        """Bind reduce-time constants from engine-injected ctx options (e.g.
        FREQUENTSTRINGS' dictionary values for its final decode)."""
        return self

    # -- device: per-segment partials -----------------------------------
    def partial(self, values, mask) -> Partial:
        raise NotImplementedError

    def partial_grouped(self, values, mask, keys, num_groups: int) -> Partial:
        raise NotImplementedError

    # -- host: post-copy conversion hook ----------------------------------
    def host_partial(self, p: Partial) -> Partial:
        """A partial copied home in its host merge form (identity for tensor
        partials; value-set sketches decode here)."""
        return p

    # -- host: combine (partials arrive as numpy) ------------------------
    def merge(self, a: Partial, b: Partial) -> Partial:
        raise NotImplementedError

    def final(self, p: Partial):
        raise NotImplementedError

    def final_dtype(self) -> np.dtype:
        return np.dtype(np.float64)


class CountFunction(AggFunction):
    name = "count"
    needs_expr = False  # COUNT(*) — COUNT(col) counts non-null via mask
    fields = ("count",)
    field_kinds = {"count": "count"}

    def partial(self, values, mask):
        return {"count": ops.masked_count(mask)}

    def partial_grouped(self, values, mask, keys, num_groups):
        return {"count": ops.group_count(mask, keys, num_groups)}

    def merge(self, a, b):
        return {"count": a["count"] + b["count"]}

    def final(self, p):
        return p["count"]

    def final_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


class SumFunction(AggFunction):
    """Carries (sum, count) so SUM over zero matching rows is SQL NULL."""

    name = "sum"
    fields = ("sum", "count")
    field_kinds = {"sum": "sum", "count": "count"}

    def partial(self, values, mask):
        return {"sum": ops.masked_sum(values, mask), "count": ops.masked_count(mask)}

    def partial_grouped(self, values, mask, keys, num_groups):
        return {
            "sum": ops.group_sum(values, mask, keys, num_groups),
            "count": ops.group_count(mask, keys, num_groups),
        }

    def merge(self, a, b):
        return {"sum": a["sum"] + b["sum"], "count": a["count"] + b["count"]}

    def final(self, p):
        return np.where(np.asarray(p["count"]) > 0, np.asarray(p["sum"], dtype=np.float64), np.nan)


class MinFunction(AggFunction):
    name = "min"
    fields = ("min", "count")
    field_kinds = {"min": "min", "count": "count"}

    def partial(self, values, mask):
        return {"min": ops.masked_min(values, mask), "count": ops.masked_count(mask)}

    def partial_grouped(self, values, mask, keys, num_groups):
        return {
            "min": ops.group_min(values, mask, keys, num_groups),
            "count": ops.group_count(mask, keys, num_groups),
        }

    def merge(self, a, b):
        return {"min": np.minimum(a["min"], b["min"]), "count": a["count"] + b["count"]}

    def final(self, p):
        return np.where(np.asarray(p["count"]) > 0, np.asarray(p["min"], dtype=np.float64), np.nan)


class MaxFunction(AggFunction):
    name = "max"
    fields = ("max", "count")
    field_kinds = {"max": "max", "count": "count"}

    def partial(self, values, mask):
        return {"max": ops.masked_max(values, mask), "count": ops.masked_count(mask)}

    def partial_grouped(self, values, mask, keys, num_groups):
        return {
            "max": ops.group_max(values, mask, keys, num_groups),
            "count": ops.group_count(mask, keys, num_groups),
        }

    def merge(self, a, b):
        return {"max": np.maximum(a["max"], b["max"]), "count": a["count"] + b["count"]}

    def final(self, p):
        return np.where(np.asarray(p["count"]) > 0, np.asarray(p["max"], dtype=np.float64), np.nan)


class AvgFunction(AggFunction):
    """Carries (sum, count) — Pinot's AvgPair intermediate result."""

    name = "avg"
    fields = ("sum", "count")
    field_kinds = {"sum": "sum", "count": "count"}

    def partial(self, values, mask):
        return {"sum": ops.masked_sum(values, mask), "count": ops.masked_count(mask)}

    def partial_grouped(self, values, mask, keys, num_groups):
        return {
            "sum": ops.group_sum(values, mask, keys, num_groups),
            "count": ops.group_count(mask, keys, num_groups),
        }

    def merge(self, a, b):
        return {"sum": a["sum"] + b["sum"], "count": a["count"] + b["count"]}

    def final(self, p):
        cnt = np.asarray(p["count"], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(cnt > 0, np.asarray(p["sum"]) / cnt, np.nan)


class MinMaxRangeFunction(AggFunction):
    """MINMAXRANGE = max - min (Pinot MinMaxRangeAggregationFunction)."""

    name = "minmaxrange"
    fields = ("min", "max", "count")
    field_kinds = {"min": "min", "max": "max", "count": "count"}

    def partial(self, values, mask):
        return {
            "min": ops.masked_min(values, mask),
            "max": ops.masked_max(values, mask),
            "count": ops.masked_count(mask),
        }

    def partial_grouped(self, values, mask, keys, num_groups):
        return {
            "min": ops.group_min(values, mask, keys, num_groups),
            "max": ops.group_max(values, mask, keys, num_groups),
            "count": ops.group_count(mask, keys, num_groups),
        }

    def merge(self, a, b):
        return {
            "min": np.minimum(a["min"], b["min"]),
            "max": np.maximum(a["max"], b["max"]),
            "count": a["count"] + b["count"],
        }

    def final(self, p):
        rng = np.asarray(p["max"], dtype=np.float64) - np.asarray(p["min"], dtype=np.float64)
        return np.where(np.asarray(p["count"]) > 0, rng, np.nan)


class SumOfSquaresFunction(AggFunction):
    """Building block for VARIANCE/STDDEV (Pinot VarianceAggregationFunction
    carries count/sum/sumOfSquares the same way)."""

    name = "_sumsq"
    fields = ("count", "sum", "sumsq")
    field_kinds = {"count": "count", "sum": "sum", "sumsq": "sumsq"}

    def partial(self, values, mask):
        return {
            "count": ops.masked_count(mask),
            "sum": ops.masked_sum(values, mask),
            "sumsq": ops.masked_sum_sq(values, mask),
        }

    def partial_grouped(self, values, mask, keys, num_groups):
        return {
            "count": ops.group_count(mask, keys, num_groups),
            "sum": ops.group_sum(values, mask, keys, num_groups),
            "sumsq": ops.group_sum_sq(values, mask, keys, num_groups),
        }

    def merge(self, a, b):
        return {k: a[k] + b[k] for k in ("count", "sum", "sumsq")}


class VarianceFunction(SumOfSquaresFunction):
    name = "variance"  # population variance (VAR_POP)

    def final(self, p):
        cnt = np.asarray(p["count"], dtype=np.float64)
        s = np.asarray(p["sum"], dtype=np.float64)
        ss = np.asarray(p["sumsq"], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean = s / cnt
            return np.where(cnt > 0, ss / cnt - mean * mean, np.nan)


class VarianceSampFunction(SumOfSquaresFunction):
    name = "varsamp"

    def final(self, p):
        cnt = np.asarray(p["count"], dtype=np.float64)
        s = np.asarray(p["sum"], dtype=np.float64)
        ss = np.asarray(p["sumsq"], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean = s / cnt
            return np.where(cnt > 1, (ss - cnt * mean * mean) / (cnt - 1), np.nan)


class StdDevFunction(VarianceFunction):
    name = "stddev"

    def final(self, p):
        return np.sqrt(super().final(p))


class StdDevSampFunction(VarianceSampFunction):
    name = "stddevsamp"

    def final(self, p):
        return np.sqrt(super().final(p))


_REGISTRY: Dict[str, AggFunction] = {}


def register(fn: AggFunction) -> None:
    _REGISTRY[fn.name] = fn


for _cls in (
    CountFunction,
    SumFunction,
    MinFunction,
    MaxFunction,
    AvgFunction,
    MinMaxRangeFunction,
    VarianceFunction,
    VarianceSampFunction,
    StdDevFunction,
    StdDevSampFunction,
):
    register(_cls())

# aliases (Pinot exposes several)
_REGISTRY["var_pop"] = _REGISTRY["variance"]
_REGISTRY["var_samp"] = _REGISTRY["varsamp"]
_REGISTRY["stddev_pop"] = _REGISTRY["stddev"]
_REGISTRY["stddev_samp"] = _REGISTRY["stddevsamp"]


# Every aggregation name of the JAX package's registry (its functions.py
# with the sketch, extended and statistics families registered).  The parser
# recognizes all of them, so one SQL text parses the same in both packages.
ALL_AGG_NAMES = frozenset({
    "arg_max", "arg_min", "argmax", "argmin", "avg", "avgmv",
    "avgvalueintegersumtuplesketch", "corr", "count", "countmv", "covar_pop",
    "covar_samp", "covarpop", "covarsamp", "distinctavg", "distinctcount",
    "distinctcountbitmap", "distinctcounthll", "distinctcountmv",
    "distinctcountrawtheta", "distinctcounttheta", "distinctcounttuplesketch",
    "distinctsum", "expr_max", "expr_min", "exprmax", "exprmin",
    "firstwithtime", "frequentlongs", "frequentstrings",
    "funnel_complete_count", "funnel_count", "funnel_max_step",
    "funnelcompletecount", "funnelcount", "funnelmaxstep", "histogram",
    "lastwithtime", "max", "maxmv", "min", "minmaxrange", "minmv", "mode",
    "percentile", "percentileest", "percentilekll", "percentiletdigest",
    "segmentpartitioneddistinctcount", "stddev", "stddev_pop", "stddev_samp",
    "stddevsamp", "sum", "summv", "sumvaluesintegersumtuplesketch", "var_pop",
    "var_samp", "variance", "varsamp",
})


def is_agg_function(name: str) -> bool:
    return name.lower() in ALL_AGG_NAMES


def get_agg_function(name: str) -> AggFunction:
    fn = _REGISTRY.get(name.lower())
    if fn is None:
        raise ValueError(f"unknown aggregation function {name!r} (have {sorted(_REGISTRY)})")
    return fn


def for_spec(spec) -> AggFunction:
    """Registry lookup + literal-arg specialization for one AggregationSpec.
    (Column binding is planner-side; merge/final never need it.)"""
    return get_agg_function(spec.function).with_args(spec.literal_args)


# Register the sketch family (import at bottom: sketches subclasses AggFunction)
from pinot_tpu_torch.query import sketches  # noqa: E402,F401

# Extended aggregations (KLL log-sketch, theta, MODE, FIRST/LAST_WITH_TIME);
# must import AFTER sketches: percentilekll overrides the histogram stand-in
from pinot_tpu_torch.query import aggs_extra  # noqa: E402,F401

# Statistics long tail (HISTOGRAM, covariance family, EXPR_MIN/MAX,
# FREQUENTSTRINGS, integer tuple sketches, funnels) — after aggs_extra
from pinot_tpu_torch.query import aggs_stats  # noqa: E402,F401
