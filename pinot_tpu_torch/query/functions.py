"""Aggregation function registry.

Port of pinot_tpu/query/functions.py: the ten core functions (COUNT, SUM,
MIN, MAX, AVG, MINMAXRANGE, VARIANCE/VARSAMP, STDDEV/STDDEVSAMP) with their
partials on torch tensors and merge/final on host numpy.  The sketch and
extended families of the JAX registry come with a later slice; their names
are known (ALL_AGG_NAMES) so SQL parses as in the JAX package and fails at
plan time.

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
}


def field_identity(field_name: str) -> float:
    op = FIELD_COMBINE[field_name]
    return 0.0 if op == "add" else (_POS_INF if op == "min" else _NEG_INF)


def combine_field(field_name: str, a, b):
    op = FIELD_COMBINE[field_name]
    if op == "add":
        return a + b
    if op == "min":
        return np.minimum(a, b)
    return np.maximum(a, b)


class AggFunction:
    """Base: one aggregation function's device/host contract."""

    name: str = ""
    # field -> entry kind ("count"|"sum"|"sumsq"|"min"|"max") for the fused
    # dense group-by scan (ops.fused_group_tables)
    field_kinds = None

    # -- device: per-segment partials -----------------------------------
    def partial(self, values, mask) -> Partial:
        raise NotImplementedError

    def partial_grouped(self, values, mask, keys, num_groups: int) -> Partial:
        raise NotImplementedError

    # -- host: combine (partials arrive as numpy) ------------------------
    def merge(self, a: Partial, b: Partial) -> Partial:
        raise NotImplementedError

    def final(self, p: Partial):
        raise NotImplementedError


class CountFunction(AggFunction):
    name = "count"
    field_kinds = {"count": "count"}

    def partial(self, values, mask):
        return {"count": ops.masked_count(mask)}

    def partial_grouped(self, values, mask, keys, num_groups):
        return {"count": ops.group_count(mask, keys, num_groups)}

    def merge(self, a, b):
        return {"count": a["count"] + b["count"]}

    def final(self, p):
        return p["count"]


class SumFunction(AggFunction):
    """Carries (sum, count) so SUM over zero matching rows is SQL NULL."""

    name = "sum"
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
# recognizes all of them, so one SQL text parses the same in both packages;
# the names this slice does not implement fail at plan time.
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
        if name.lower() in ALL_AGG_NAMES:
            raise NotImplementedError(
                f"aggregation {name!r} is not ported yet (sketches and extended "
                "aggregations are a later slice of the port)"
            )
        raise ValueError(f"unknown aggregation function {name!r} (have {sorted(_REGISTRY)})")
    return fn


def for_spec(spec) -> AggFunction:
    """Registry lookup for one AggregationSpec (the core functions take no
    literal arguments)."""
    return get_agg_function(spec.function)
