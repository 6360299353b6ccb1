"""Aggregation long tail: HISTOGRAM, covariance family, EXPR_MIN/EXPR_MAX,
FREQUENTSTRINGS, the integer tuple sketches and the funnel family.

Port of pinot_tpu/query/aggs_stats.py.  Reference parity:
HistogramAggregationFunction, CovarianceAggregationFunction (and its CORR
sibling), ParentExprMinMaxAggregationFunction,
FrequentStringsSketchAggregationFunction, IntegerTupleSketch /
SumValues / AvgValue IntegerSumTupleSketch, FunnelCount /
FunnelCompleteCount / FunnelMaxStep.

  * HISTOGRAM: bucket ids by a sorted-edge search, one additive [bins]
    partial.  Bins are [e_i, e_{i+1}) with the last bin closed; values
    outside [e_0, e_last] drop.
  * COVAR_POP/COVAR_SAMP/CORR: the CovarianceTuple as additive fields in
    float64 (the JAX package's CPU "wide" policy; the H100 has f64 ALUs).
  * EXPR_MIN/EXPR_MAX: the projection at the extremal measure; ties take
    the LARGEST projection; (m, v) merges pairwise.
  * FREQUENTSTRINGS: FREQUENTLONGS' histogram over shared dictionary codes,
    decoded through the dictionary at final (bind_reduce).
  * The tuple sketches: KMV over key hashes where each retained hash
    carries the sum of its rows' values; merges pairwise.
  * FUNNEL*: per-step presence tables over the CORRELATEBY key domain; with
    TIMESTAMPBY the ordered form, whose per-key sorted row scan is the
    hand-written CUDA kernel of ops/funnel_scan.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pinot_tpu_torch.ops import funnel_scan
from pinot_tpu_torch.ops import segmented as ops
from pinot_tpu_torch.query.aggs_extra import (
    FrequentLongsFunction,
    as_tensor,
    distinct_ranks,
    extreme_pair_grouped,
    extreme_pair_merge,
    like_input,
    sort_two_keys,
)
from pinot_tpu_torch.query.functions import _REGISTRY, AggFunction, register
from pinot_tpu_torch.query.sketches import (
    ColumnBinding,
    _check_cell_budget,
    _device_hash62,
    _flat_cells,
    masked_cells,
)

_I64_MAX = int(np.iinfo(np.int64).max)


# ---------------------------------------------------------------------------
# HISTOGRAM
# ---------------------------------------------------------------------------
class HistogramFunction(AggFunction):
    name = "histogram"
    vector_fields = True
    fields = ("hist",)

    def __init__(self, edges: Optional[np.ndarray] = None):
        self.edges = None if edges is None else np.asarray(edges, dtype=np.float64)

    def with_args(self, literal_args):
        if len(literal_args) == 1:
            s = str(literal_args[0]).strip()
            if s.upper().startswith("ARRAY"):
                s = s[5:].strip()
            edges = np.asarray([float(x) for x in s.strip("[]() ").split(",")], np.float64)
        elif len(literal_args) == 3:
            lo, hi, bins = (float(literal_args[0]), float(literal_args[1]), int(literal_args[2]))
            if bins <= 0 or hi <= lo:
                raise ValueError(f"HISTOGRAM needs upper > lower and numBins > 0, got {literal_args}")
            edges = np.linspace(lo, hi, bins + 1)
        else:
            raise ValueError(
                "HISTOGRAM takes (col, lower, upper, numBins) or (col, '<edge,edge,...>'), "
                f"got {len(literal_args) + 1} arguments"
            )
        if len(edges) < 2 or np.any(np.diff(edges) <= 0):
            raise ValueError(f"HISTOGRAM bin edges must be strictly increasing, got {edges}")
        return HistogramFunction(edges)

    @property
    def width(self) -> int:
        return len(self.edges) - 1

    def _bucket(self, values: torch.Tensor):
        """(bucket ids, in-range mask), compared in float64."""
        v = values.to(torch.float64)
        e = torch.as_tensor(self.edges, dtype=torch.float64).to(v.device)
        inb = (v >= e[0]) & (v <= e[-1])
        # interior edges only: the top edge folds into the last bin
        b = torch.searchsorted(e[1:-1].contiguous(), v.contiguous(), right=True)
        return b, inb

    def partial(self, values, mask):
        b, inb = self._bucket(values)
        return {"hist": ops.group_count(mask & inb, b, self.width)}

    def partial_grouped(self, values, mask, keys, num_groups):
        _check_cell_budget(self.name, num_groups, self.width)
        b, inb = self._bucket(values)
        flat = _flat_cells(keys, self.width, b)
        return {"hist": ops.group_count(mask & inb, flat, num_groups * self.width).reshape(num_groups, self.width)}

    def merge(self, a, b):
        return {"hist": np.asarray(a["hist"]) + np.asarray(b["hist"])}

    def final(self, p):
        hist = np.asarray(p["hist"], dtype=np.float64)
        one = hist.ndim == 1
        hist = np.atleast_2d(hist)
        out = np.empty(hist.shape[0], dtype=object)
        for g in range(hist.shape[0]):
            out[g] = [float(c) for c in hist[g]]
        return out[0] if one else out


# ---------------------------------------------------------------------------
# COVAR_POP / COVAR_SAMP / CORR
# ---------------------------------------------------------------------------
class CovarianceFunction(AggFunction):
    """COVAR_POP(x, y): E[XY] - E[X]E[Y] over matching rows; the partial is
    the CovarianceTuple as an additive float64 field dict."""

    name = "covar_pop"
    needs_extra_exprs = True
    fields = ("count", "sumx", "sumy", "sumxy")
    sample = False

    @staticmethod
    def _floats(values):
        return values[0].to(torch.float64), values[1].to(torch.float64)

    def partial(self, values, mask):
        x, y = self._floats(values)
        return {
            "count": ops.masked_count(mask),
            "sumx": ops.masked_sum(x, mask),
            "sumy": ops.masked_sum(y, mask),
            "sumxy": ops.masked_sum(x * y, mask),
        }

    def partial_grouped(self, values, mask, keys, num_groups):
        x, y = self._floats(values)
        return {
            "count": ops.group_count(mask, keys, num_groups),
            "sumx": ops.group_sum(x, mask, keys, num_groups),
            "sumy": ops.group_sum(y, mask, keys, num_groups),
            "sumxy": ops.group_sum(x * y, mask, keys, num_groups),
        }

    def merge(self, a, b):
        return {k: np.asarray(a[k]) + np.asarray(b[k]) for k in self.fields}

    def final(self, p):
        n = np.asarray(p["count"], dtype=np.float64)
        sx = np.asarray(p["sumx"], dtype=np.float64)
        sy = np.asarray(p["sumy"], dtype=np.float64)
        sxy = np.asarray(p["sumxy"], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            cov = sxy / n - (sx / n) * (sy / n)
            if self.sample:
                return np.where(n > 1, cov * n / (n - 1), np.nan)
            return np.where(n > 0, cov, np.nan)


class CovarianceSampFunction(CovarianceFunction):
    name = "covar_samp"
    sample = True


class CorrelationFunction(CovarianceFunction):
    """CORR(x, y): Pearson correlation (the covariance tuple plus the sums
    of squares)."""

    name = "corr"
    fields = ("count", "sumx", "sumy", "sumxy", "sumsqx", "sumsqy")

    def partial(self, values, mask):
        x, y = self._floats(values)
        p = CovarianceFunction.partial(self, values, mask)
        p["sumsqx"] = ops.masked_sum(x * x, mask)
        p["sumsqy"] = ops.masked_sum(y * y, mask)
        return p

    def partial_grouped(self, values, mask, keys, num_groups):
        x, y = self._floats(values)
        p = CovarianceFunction.partial_grouped(self, values, mask, keys, num_groups)
        p["sumsqx"] = ops.group_sum(x * x, mask, keys, num_groups)
        p["sumsqy"] = ops.group_sum(y * y, mask, keys, num_groups)
        return p

    def final(self, p):
        n = np.asarray(p["count"], dtype=np.float64)
        sx = np.asarray(p["sumx"], dtype=np.float64)
        sy = np.asarray(p["sumy"], dtype=np.float64)
        sxy = np.asarray(p["sumxy"], dtype=np.float64)
        ssx = np.asarray(p["sumsqx"], dtype=np.float64)
        ssy = np.asarray(p["sumsqy"], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            covn = sxy - sx * sy / n
            varxn = ssx - sx * sx / n
            varyn = ssy - sy * sy / n
            return np.where((n > 0) & (varxn > 0) & (varyn > 0), covn / np.sqrt(varxn * varyn), np.nan)


# ---------------------------------------------------------------------------
# EXPR_MIN / EXPR_MAX (argmin / argmax)
# ---------------------------------------------------------------------------
class ExprMaxFunction(AggFunction):
    """EXPR_MAX(projection, measure): the projection at the max measure;
    values arrives as (projection, measure) via extra_exprs.  Measure ties
    take the max projection value."""

    name = "exprmax"
    needs_extra_exprs = True
    vector_fields = True  # coupled fields: keep off generic field combines
    pairwise_merge = True
    fields = ("m", "v")
    pick_max = True

    def _prep(self, values, mask):
        v, m = values[0], values[1]
        sign = 1.0 if self.pick_max else -1.0
        ninf = torch.full((), float("-inf"), dtype=torch.float64, device=mask.device)
        mm = torch.where(mask, m.to(torch.float64) * sign, ninf)
        return v.to(torch.float64), mm, sign

    def partial(self, values, mask):
        v, mm, sign = self._prep(values, mask)
        mbest = torch.max(mm)
        best = mask & (mm == mbest)
        ninf = torch.full((), float("-inf"), dtype=torch.float64, device=v.device)
        return {"m": mbest * sign, "v": torch.max(torch.where(best, v, ninf))}

    def partial_grouped(self, values, mask, keys, num_groups):
        v, mm, sign = self._prep(values, mask)
        mbest, vbest = extreme_pair_grouped(v, mm, mask, keys, num_groups)
        return {"m": mbest * sign, "v": vbest}

    def merge(self, a, b):
        m, v = extreme_pair_merge(a["m"], a["v"], b["m"], b["v"], 1.0 if self.pick_max else -1.0)
        return {"m": m, "v": v}

    def final(self, p):
        m = np.asarray(p["m"], dtype=np.float64)
        return np.where(np.isfinite(m), np.asarray(p["v"], np.float64), np.nan)


class ExprMinFunction(ExprMaxFunction):
    name = "exprmin"
    pick_max = False


# ---------------------------------------------------------------------------
# FREQUENTSTRINGS: exact top-k over dictionary codes
# ---------------------------------------------------------------------------
class FrequentStringsFunction(FrequentLongsFunction):
    name = "frequentstrings"
    input_kind = "codes"

    def __init__(self, domain: int = 0, k: int = 10, dict_values: Optional[np.ndarray] = None):
        # base 0: codes ARE the offsets on the shared dictionary key space
        FrequentLongsFunction.__init__(self, domain=domain, base=0, k=k)
        self.dict_values = dict_values

    def with_args(self, literal_args):
        k = int(literal_args[0]) if literal_args else 10
        return FrequentStringsFunction(k=k)

    def bind_column(self, info: ColumnBinding):
        if info.kind != "dict" or info.dict_values is None:
            raise NotImplementedError(
                "FREQUENTSTRINGS requires a dictionary-encoded column with a "
                "shared key space across segments"
            )
        return FrequentStringsFunction(domain=info.domain, k=self.k, dict_values=info.dict_values)

    def bind_reduce(self, ctx, spec):
        """final() decodes codes through the dictionary, which the reduce
        side's registry singleton lacks: the engines inject it as a ctx
        option (__dictvals__<col>, beside __dictfp__)."""
        dv = ctx.options.get(f"__dictvals__{spec.expr.op}") if spec.expr is not None else None
        if dv is None:
            raise NotImplementedError(
                "FREQUENTSTRINGS reduce needs engine-injected dictionary values "
                "(__dictvals__ option missing)"
            )
        return FrequentStringsFunction(k=self.k, dict_values=dv)

    def final(self, p):
        hist = np.atleast_2d(np.asarray(p["hist"]))
        out = np.empty(hist.shape[0], dtype=object)
        for g in range(hist.shape[0]):
            nz = np.nonzero(hist[g])[0]
            top = nz[np.argsort(-hist[g][nz], kind="stable")][: self.k]
            out[g] = [str(self.dict_values[c]) for c in top]
        return out[0] if np.asarray(p["hist"]).ndim == 1 else out


# ---------------------------------------------------------------------------
# Integer tuple sketch: KMV + summary per retained hash
# ---------------------------------------------------------------------------
def tuple_merge(ak, ap, bk, bp):
    """Hash-aligned pairwise merge of (kmv, pay) rows: concat along the K
    axis, sort by hash, fold duplicate neighbours' payloads left, keep the
    K smallest.  numpy or torch in, the same kind out."""
    tak, tbk = as_tensor(ak), as_tensor(bk)
    x = torch.cat([tak, tbk], dim=-1)
    p = torch.cat([as_tensor(ap).to(torch.float64), as_tensor(bp).to(torch.float64)], dim=-1)
    order = torch.sort(x, dim=-1, stable=True).indices
    x = torch.take_along_dim(x, order, -1)
    p = torch.take_along_dim(p, order, -1)
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    # runs have length <= 2: each side holds distinct hashes
    zero = torch.zeros((), dtype=torch.float64, device=p.device)
    p = p + torch.roll(torch.where(dup, p, zero), -1, dims=-1)
    p = torch.where(dup, zero, p)
    x = torch.where(dup, torch.full_like(x, _I64_MAX), x)
    order = torch.sort(x, dim=-1, stable=True).indices
    x = torch.take_along_dim(x, order, -1)
    p = torch.take_along_dim(p, order, -1)
    k = min(tak.shape[-1], tbk.shape[-1])
    return like_input(x[..., :k].contiguous(), ak), like_input(p[..., :k].contiguous(), ak)


class IntegerTupleSketchFunction(AggFunction):
    """DISTINCTCOUNTTUPLESKETCH(key, value): KMV over key hashes where each
    retained hash carries the SUM of its rows' values (datasketches
    integer-sum Tuple mode).  final() by `estimate`: distinct -> (K-1)/theta,
    sum -> sum(retained summaries)/theta, avg -> mean retained summary."""

    name = "distinctcounttuplesketch"
    needs_codes = True
    needs_binding = True
    needs_extra_exprs = True
    vector_fields = True
    pairwise_merge = True
    input_kind = "values_hash"
    fields = ("kmv", "pay")
    estimate = "distinct"

    K = 4096
    GROUPED_K = 256

    def bind_column(self, info: ColumnBinding):
        return self  # hash-based

    def partial(self, values, mask):
        return {k: t[0] for k, t in self.partial_grouped(values, mask, None, 1).items()}

    def partial_grouped(self, values, mask, keys, num_groups):
        """One sort by (group, hash) gives the distinct ranks AND the
        per-key payload sums (prefix sums differenced at run starts)."""
        v, pay = values[0], values[1]
        dev = mask.device
        if num_groups == 1:
            kk = self.K
            gk = torch.where(mask, torch.zeros((), dtype=torch.int64, device=dev),
                             torch.ones((), dtype=torch.int64, device=dev))
        else:
            kk = max(16, min(self.GROUPED_K, 2_000_000 // max(1, num_groups)))
            gk = torch.where(mask, keys.to(torch.int64), torch.full((), num_groups, dtype=torch.int64, device=dev))
        _check_cell_budget(self.name, num_groups, kk)
        n = int(mask.shape[0])
        h = torch.where(mask, _device_hash62(v), torch.full((), _I64_MAX, dtype=torch.int64, device=dev))
        payf = torch.where(mask, pay.to(torch.float64), torch.zeros((), dtype=torch.float64, device=dev))
        perm = sort_two_keys(gk, h)
        s_k, s_h, s_pay = gk[perm], h[perm], payf[perm]
        new, _, rank = distinct_ranks(s_k, s_h, num_groups)
        iota = torch.arange(n, device=dev)
        # per-key payload sum: prefix sums differenced between run starts
        # (the next run start from a reversed cummin)
        p0 = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev), torch.cumsum(s_pay, 0)])
        starts_at = torch.where(new, iota, torch.full((), n, dtype=torch.int64, device=dev))
        nxt_ge = torch.flip(torch.cummin(torch.flip(starts_at, [0]), 0).values, [0])
        nxt = torch.cat([nxt_ge[1:], torch.full((1,), n, dtype=torch.int64, device=dev)])
        run_sum = p0[nxt] - p0[iota]
        cells = num_groups * kk
        slot = torch.where(new & (rank < kk), s_k * kk + rank, torch.full((), cells, dtype=torch.int64, device=dev))
        kmv = torch.full((cells + 1,), _I64_MAX, dtype=torch.int64, device=dev).scatter_(0, slot, s_h)
        pays = torch.zeros(cells + 1, dtype=torch.float64, device=dev).scatter_(0, slot, run_sum)
        return {"kmv": kmv[:cells].reshape(num_groups, kk), "pay": pays[:cells].reshape(num_groups, kk)}

    def merge(self, a, b):
        kmv, pay = tuple_merge(a["kmv"], a["pay"], b["kmv"], b["pay"])
        return {"kmv": kmv, "pay": pay}

    def final(self, p):
        kmv = np.asarray(p["kmv"])
        pay = np.asarray(p["pay"], dtype=np.float64)
        one = kmv.ndim == 1
        kmv = np.atleast_2d(kmv)
        pay = np.atleast_2d(pay)
        k = kmv.shape[-1]
        valid = kmv != _I64_MAX
        n_v = valid.sum(axis=-1)
        kth = kmv[..., -1].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            theta = np.where(n_v < k, 1.0, kth / float(1 << 62))
            if self.estimate == "distinct":
                out = np.where(n_v < k, n_v, (n_v - 1) / theta)
            elif self.estimate == "sum":
                psum = np.where(valid, pay, 0.0)
                # saturated: drop the theta-defining Kth entry, scale by 1/theta
                psum = np.where(
                    (n_v < k)[..., None], psum, np.where(np.arange(k)[None, :] < k - 1, psum, 0.0),
                )
                out = psum.sum(axis=-1) / theta
            else:  # avg summary value among retained keys
                cnt = np.where(n_v < k, n_v, n_v - 1)
                psum = np.where(valid, pay, 0.0).sum(axis=-1)
                psum = np.where(n_v < k, psum, psum - np.where(valid[..., -1], pay[..., -1], 0.0))
                out = np.where(cnt > 0, psum / np.maximum(cnt, 1), np.nan)
        return out[0] if one else out


class SumValuesTupleSketchFunction(IntegerTupleSketchFunction):
    name = "sumvaluesintegersumtuplesketch"
    estimate = "sum"


class AvgValueTupleSketchFunction(IntegerTupleSketchFunction):
    name = "avgvalueintegersumtuplesketch"
    estimate = "avg"


# ---------------------------------------------------------------------------
# Funnel family: per-step correlate-key presence tables
# ---------------------------------------------------------------------------
class FunnelCountFunction(AggFunction):
    """FUNNELCOUNT(STEPS(cond1, ..., condS), CORRELATEBY(col)): per step s,
    how many correlate keys matched ALL of steps 1..s (the set-intersection
    funnel).  Per-step presence tables over the correlate key domain, an
    [S, domain] int32 partial merged by max; the prefix AND and the counts
    happen at final.  Keys need a shared dictionary or a bounded int range.

    ORDERED mode (TIMESTAMPBY(col) [, window]): the partial is the deepest
    step each key REACHED in timestamp order (window measured from the
    chain's first step), computed by ops.funnel_scan (a per-key sorted
    row scan: the CUDA kernel on the card).  present[s] = reach > s is
    prefix-monotone, so the same max merge and final apply.  A chain whose
    steps span two segments of one key is undercounted (never inflated), as
    in the JAX package."""

    name = "funnelcount"
    needs_codes = True
    needs_binding = True
    needs_extra_exprs = True
    vector_fields = True
    fields = ("present",)
    mode = "counts"  # counts | complete | maxstep
    input_kind = "codes"

    def __init__(self, domain: int = 0, base: int = 0, input_kind: str = "codes", ordered: bool = False,
                 window: float = float("inf")):
        self.domain = domain
        self.base = base
        self.input_kind = input_kind
        self.ordered = ordered
        self.window = window

    def _rebind(self, **kw):
        cur = dict(domain=self.domain, base=self.base, input_kind=self.input_kind, ordered=self.ordered,
                   window=self.window)
        cur.update(kw)
        return type(self)(**cur)

    def with_args(self, literal_args):
        if not literal_args:
            return self
        # the parser emits literal_args=(window,) iff TIMESTAMPBY is present
        return self._rebind(ordered=True, window=float(literal_args[0]))

    def bind_column(self, info: ColumnBinding):
        if info.kind == "dict":
            return self._rebind(domain=info.domain, input_kind="codes")
        if info.kind == "rawint":
            return self._rebind(domain=info.domain, base=info.base, input_kind="values_offset")
        raise NotImplementedError(f"{self.name.upper()} needs a dictionary or bounded-int CORRELATEBY column")

    def _reach_rows(self, codes, steps, ts, mask, num_groups: int, keys, axis: int):
        """[S] presence rows (stacked at `axis`) from the ordered reach table."""
        cells = num_groups * self.domain
        flat = codes if keys is None else _flat_cells(keys, self.domain, codes)
        tbl = funnel_scan.funnel_reach(flat, steps, ts, mask, cells, self.window)
        if keys is not None:
            tbl = tbl.reshape(num_groups, self.domain)
        return torch.stack([(tbl > s).to(torch.int32) for s in range(len(steps))], dim=axis)

    def partial(self, values, mask):
        if self.ordered:
            codes, *rest = values
            steps, ts = rest[:-1], rest[-1]
            _check_cell_budget(self.name, len(steps), self.domain)
            return {"present": self._reach_rows(codes, steps, ts, mask, 1, None, 0)}  # [S, domain]
        codes, *steps = values
        _check_cell_budget(self.name, len(steps), self.domain)
        codes = masked_cells(mask, codes)
        rows = [
            (ops.group_count(mask & s.to(torch.bool), codes, self.domain) > 0).to(torch.int32)
            for s in steps
        ]
        return {"present": torch.stack(rows, dim=0)}  # [S, domain]

    def partial_grouped(self, values, mask, keys, num_groups):
        if self.ordered:
            codes, *rest = values
            steps, ts = rest[:-1], rest[-1]
            _check_cell_budget(self.name, num_groups * len(steps), self.domain)
            return {"present": self._reach_rows(codes, steps, ts, mask, num_groups, keys, 1)}  # [G, S, domain]
        codes, *steps = values
        _check_cell_budget(self.name, num_groups * len(steps), self.domain)
        flat = masked_cells(mask, _flat_cells(keys, self.domain, codes))
        cells = num_groups * self.domain
        rows = [
            (ops.group_count(mask & s.to(torch.bool), flat, cells) > 0).to(torch.int32).reshape(num_groups, self.domain)
            for s in steps
        ]
        return {"present": torch.stack(rows, dim=1)}  # [G, S, domain]

    def merge(self, a, b):
        return {"present": np.maximum(np.asarray(a["present"]), np.asarray(b["present"]))}

    def final(self, p):
        pres = np.asarray(p["present"])
        one = pres.ndim == 2
        if one:
            pres = pres[None]  # [1, S, domain]
        prefix = np.cumprod(pres > 0, axis=1)  # AND over steps 1..s
        if self.mode == "counts":
            counts = prefix.sum(axis=2)  # [G, S]
            out = np.empty(counts.shape[0], dtype=object)
            for g in range(counts.shape[0]):
                out[g] = [int(c) for c in counts[g]]
        elif self.mode == "complete":
            out = prefix[:, -1, :].sum(axis=1).astype(np.int64)
        else:  # maxstep: deepest step any correlate key completed
            out = prefix.sum(axis=1).max(axis=1).astype(np.int64)
        return out[0] if one else out


class FunnelCompleteCountFunction(FunnelCountFunction):
    name = "funnelcompletecount"
    mode = "complete"


class FunnelMaxStepFunction(FunnelCountFunction):
    name = "funnelmaxstep"
    mode = "maxstep"


for _cls in (
    HistogramFunction,
    CovarianceFunction,
    CovarianceSampFunction,
    CorrelationFunction,
    ExprMaxFunction,
    ExprMinFunction,
    FrequentStringsFunction,
    IntegerTupleSketchFunction,
    SumValuesTupleSketchFunction,
    AvgValueTupleSketchFunction,
    FunnelCountFunction,
    FunnelCompleteCountFunction,
    FunnelMaxStepFunction,
):
    register(_cls())

# the reference exposes both spellings
for _alias, _target in (
    ("expr_max", "exprmax"),
    ("expr_min", "exprmin"),
    ("argmax", "exprmax"),
    ("argmin", "exprmin"),
    ("arg_max", "exprmax"),
    ("arg_min", "exprmin"),
    ("covarpop", "covar_pop"),
    ("covarsamp", "covar_samp"),
    ("funnel_count", "funnelcount"),
    ("funnel_complete_count", "funnelcompletecount"),
    ("funnel_max_step", "funnelmaxstep"),
):
    _REGISTRY[_alias] = _REGISTRY[_target]
