"""Aggregation breadth: log-bucket percentile sketch, theta distinct count,
MODE, FREQUENTLONGS, DISTINCTSUM/AVG, FIRST/LAST_WITH_TIME.

Port of pinot_tpu/query/aggs_extra.py.  Reference parity:
pinot-core/.../query/aggregation/function/ PercentileKLLAggregationFunction,
DistinctCountThetaSketchAggregationFunction, ModeAggregationFunction,
FrequentLongsSketchAggregationFunction, DistinctSum/DistinctAvg,
FirstWithTime/LastWithTimeAggregationFunction.

  * PERCENTILEKLL -> a DDSketch-style LOG-BUCKETED histogram (relative value
    error alpha), a fixed-size additive partial.
  * DISTINCTCOUNTTHETA -> KMV: the K smallest distinct 62-bit row hashes
    (sort + cumsum compaction), optionally one row per sub-filter with a
    set expression evaluated at final; merges pairwise.
  * MODE / FREQUENTLONGS / DISTINCTSUM / DISTINCTAVG -> a value-offset
    histogram over a bounded int range; finals read it.
  * FIRST/LAST_WITH_TIME -> per-group time max with a second max over the
    values of the time-ties; (t, v) merges pairwise by time.

The pairwise merges take numpy arrays (the reduce) or torch tensors (the
distributed engine's combine across launches, on the device) and return
the same kind.

The multi-value forms COUNTMV / SUMMV / MINMV / MAXMV / AVGMV /
DISTINCTCOUNTMV (MVAggFunction) run their single-value function over every
ELEMENT of an MV column: the planner hands them the padded [rows, max_len]
element matrix with a row-filter x length mask (planner.mv_agg_input).
"""
from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.ops import segmented as ops
from pinot_tpu_torch.query.functions import _REGISTRY, AggFunction, get_agg_function, register
from pinot_tpu_torch.query.sketches import (
    ColumnBinding,
    _check_cell_budget,
    _device_hash62,
    _flat_cells,
    masked_cells,
)

_I64_MAX = int(np.iinfo(np.int64).max)


def as_tensor(x) -> torch.Tensor:
    """A partial field as a torch tensor (numpy arrays wrap without a copy)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def like_input(t: torch.Tensor, example):
    """`t` back in the kind of `example`: numpy for numpy partials."""
    return t if isinstance(example, torch.Tensor) else t.numpy()


def _prev(x: torch.Tensor) -> torch.Tensor:
    """x shifted right by one with -1 in front (the sorted-run boundary test)."""
    return torch.cat([torch.full((1,), -1, dtype=x.dtype, device=x.device), x[:-1]])


def sort_two_keys(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by (primary, secondary): a stable sort by
    the secondary key, then a stable sort by the primary (lax.sort with
    num_keys=2; rows equal in both keys keep their input order)."""
    p1 = torch.sort(secondary, stable=True).indices
    return p1[torch.sort(primary[p1], stable=True).indices]


def distinct_ranks(s_k: torch.Tensor, s_h: torch.Tensor, num_groups: int):
    """Over rows sorted by (group, hash): (first row of each distinct
    (group, hash) run of a real group and hash, group starts, the 0-based
    distinct rank within the group) — cumsum with per-group resets."""
    grp_start = s_k != _prev(s_k)
    new = (grp_start | (s_h != _prev(s_h))) & (s_k < num_groups) & (s_h != _I64_MAX)
    new_i = new.to(torch.int64)
    c = torch.cumsum(new_i, 0)
    base = torch.cummax(torch.where(grp_start, c - new_i, torch.zeros_like(c)), 0).values
    return new, grp_start, c - 1 - base


# ---------------------------------------------------------------------------
# PERCENTILEKLL: log-bucketed (DDSketch-style) quantile histogram
# ---------------------------------------------------------------------------
class PercentileLogSketchFunction(AggFunction):
    name = "percentilekll"
    vector_fields = True
    fields = ("hist",)

    # magnitude contract: values with |v| in [MIN_MAG, MAX_MAG] keep the
    # relative-error bound; smaller collapse into the zero bucket, larger
    # clamp into the top bucket.
    MIN_MAG = 1e-9
    MAX_MAG = 1e12

    def __init__(self, rank: float = 50.0, alpha: float = 0.01):
        self.rank = float(rank)
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self.lg = math.log(self.gamma)
        # buckets per sign covering [MIN_MAG, MAX_MAG]
        self.bins = int(math.ceil(math.log(self.MAX_MAG / self.MIN_MAG) / self.lg)) + 1
        self.min_idx = int(math.floor(math.log(self.MIN_MAG) / self.lg))
        self.width = 2 * self.bins + 1  # neg | zero | pos

    def with_args(self, literal_args):
        rank = float(literal_args[0]) if literal_args else 50.0
        # 2nd literal: Pinot's kllSize K; mapped to alpha = 2/K (K=200 -> 1%)
        alpha = 2.0 / float(literal_args[1]) if len(literal_args) > 1 else 0.01
        return PercentileLogSketchFunction(rank, alpha)

    def _bucket(self, values: torch.Tensor) -> torch.Tensor:
        v = values.to(torch.float64)
        av = torch.abs(v)
        safe = torch.clamp(av, min=self.MIN_MAG)
        # float64 -> int32 truncates toward zero, as XLA's convert does
        idx = torch.clamp((torch.log(safe) / self.lg).to(torch.int32) - self.min_idx, 0, self.bins - 1)
        center = self.bins
        return torch.where(
            av < self.MIN_MAG,
            torch.full((), center, dtype=torch.int32, device=v.device),
            torch.where(v > 0, center + 1 + idx, center - 1 - idx),
        )

    def partial(self, values, mask):
        return {"hist": ops.group_count(mask, self._bucket(values), self.width)}

    def partial_grouped(self, values, mask, keys, num_groups):
        _check_cell_budget(self.name, num_groups, self.width)
        flat = _flat_cells(keys, self.width, self._bucket(values))
        return {"hist": ops.group_count(mask, flat, num_groups * self.width).reshape(num_groups, self.width)}

    def merge(self, a, b):
        return {"hist": np.asarray(a["hist"]) + np.asarray(b["hist"])}

    def _bucket_value(self, g: int) -> float:
        """Representative value of global bucket g (midpoint in log space)."""
        center = self.bins
        if g == center:
            return 0.0
        i = abs(g - center) - 1
        mag = math.exp((i + self.min_idx) * self.lg) * (2.0 * self.gamma / (self.gamma + 1.0))
        return mag if g > center else -mag

    def final(self, p):
        hist = np.atleast_2d(np.asarray(p["hist"], dtype=np.float64))
        n_groups = hist.shape[0]
        out = np.full(n_groups, np.nan)
        for g in range(n_groups):
            total = hist[g].sum()
            if total == 0:
                continue
            target = self.rank / 100.0 * total
            cum = np.cumsum(hist[g])
            idx = min(int(np.searchsorted(cum, target, side="left")), self.width - 1)
            out[g] = self._bucket_value(idx)
        return out[0] if np.asarray(p["hist"]).ndim == 1 else out


# ---------------------------------------------------------------------------
# DISTINCTCOUNTTHETA: KMV sketch (K smallest distinct hashes)
# ---------------------------------------------------------------------------
_SET_EXPR_RX = re.compile(r"^\s*(?:\$\d+|(?:SET_UNION|SET_INTERSECT|SET_DIFF)\s*\()", re.IGNORECASE)


def kmv_merge(a, b):
    """Merge KMV rows along the last axis: concat, sort, duplicate
    neighbours to MAX, re-sort, keep the K smallest ([K] and [G, K])."""
    ta, tb = as_tensor(a), as_tensor(b)
    x = torch.sort(torch.cat([ta, tb], dim=-1), dim=-1).values
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    x = torch.sort(torch.where(dup, torch.full_like(x, _I64_MAX), x), dim=-1).values
    k = min(ta.shape[-1], tb.shape[-1])
    return like_input(x[..., :k].contiguous(), a)


class DistinctCountThetaFunction(AggFunction):
    """KMV theta sketch, optionally with SUB-FILTER set expressions
    (DistinctCountThetaSketchAggregationFunction's 'filter1', ...,
    'SET_INTERSECT($1, $2)' literal arguments): each filter string compiles
    through the FilterCompiler, the partial holds one KMV row per filter,
    and final evaluates the set expression over (hash set, theta) pairs."""

    name = "distinctcounttheta"
    needs_codes = True
    needs_binding = True
    vector_fields = True
    pairwise_merge = True
    input_kind = "values_hash"
    fields = ("kmv",)

    K = 4096
    GROUPED_K = 256  # per-group sketch width (the cell budget bounds it further)

    def __init__(self, filter_exprs: Tuple[str, ...] = (), post_expr: Optional[str] = None):
        self.filter_exprs = tuple(filter_exprs)
        self.post_expr = post_expr
        if filter_exprs:
            from pinot_tpu_torch.sql.parser import parse_filter_expression

            self.filter_nodes = tuple(parse_filter_expression(s) for s in self.filter_exprs)
        else:
            self.filter_nodes = ()

    @property
    def subfilter_args(self) -> bool:
        return bool(self.filter_exprs)

    def with_args(self, literal_args):
        if not literal_args:
            return self
        lits = [str(a) for a in literal_args]
        # the set expression is recognized by SHAPE ($i / SET_* call)
        if _SET_EXPR_RX.match(lits[-1]):
            filters, post = tuple(lits[:-1]), lits[-1]
            if not filters:
                raise ValueError("theta set expression given without any sub-filters")
        else:
            filters, post = tuple(lits), None
        if filters and post is None:
            if len(filters) > 1:
                raise ValueError(
                    "multiple theta sub-filters need a set expression (e.g. 'SET_INTERSECT($1, $2)')"
                )
            post = "$1"  # single filter: the sketch of the filtered rows
        return DistinctCountThetaFunction(filters, post)

    def bind_column(self, info: ColumnBinding) -> "DistinctCountThetaFunction":
        return self  # hash-based: no per-column constants

    def partial(self, values, mask):
        if self.filter_exprs:
            # values = (raw values, subfilter_mask_1, ..., subfilter_mask_F)
            v, *fmasks = values
            return {"kmv": torch.stack([self._one_sketch(v, mask & fm) for fm in fmasks], dim=0)}
        return {"kmv": self._one_sketch(values, mask)}

    def _one_sketch(self, values, mask):
        dev = mask.device
        h = torch.where(mask, _device_hash62(values), torch.full((), _I64_MAX, dtype=torch.int64, device=dev))
        s = torch.sort(h).values
        is_new = (s != _prev(s)) & (s != _I64_MAX)
        idx = torch.cumsum(is_new.to(torch.int64), 0) - 1
        # ALWAYS full width: segments with fewer than K distinct hashes pad
        # with the sentinel and stay exact
        k = self.K
        slot = torch.where(is_new & (idx < k), idx, torch.full((), k, dtype=torch.int64, device=dev))
        return torch.full((k + 1,), _I64_MAX, dtype=torch.int64, device=dev).scatter_(0, slot, s)[:k]

    def partial_grouped(self, values, mask, keys, num_groups):
        """Per-group K smallest DISTINCT hashes through one two-key sort by
        (group, hash): distinct ranks from cumulative counts with per-group
        resets; ranks < K scatter into the [G, K] table."""
        if self.filter_exprs:
            raise NotImplementedError("theta sub-filter set expressions do not support GROUP BY")
        dev = mask.device
        kk = max(16, min(self.GROUPED_K, 2_000_000 // max(1, num_groups)))
        _check_cell_budget(self.name, num_groups, kk)
        gk = torch.where(mask, keys.to(torch.int64), torch.full((), num_groups, dtype=torch.int64, device=dev))
        h = torch.where(mask, _device_hash62(values), torch.full((), _I64_MAX, dtype=torch.int64, device=dev))
        perm = sort_two_keys(gk, h)
        s_k, s_h = gk[perm], h[perm]
        new, _, rank = distinct_ranks(s_k, s_h, num_groups)
        cells = num_groups * kk
        slot = torch.where(new & (rank < kk), s_k * kk + rank, torch.full((), cells, dtype=torch.int64, device=dev))
        kmv = torch.full((cells + 1,), _I64_MAX, dtype=torch.int64, device=dev).scatter_(0, slot, s_h)
        return {"kmv": kmv[:cells].reshape(num_groups, kk)}

    def merge(self, a, b):
        return {"kmv": kmv_merge(a["kmv"], b["kmv"])}

    def final(self, p):
        kmv = np.asarray(p["kmv"])
        if self.post_expr is not None and kmv.ndim == 2:
            # kmv rows are per-subfilter sketches; evaluate the set expression
            sets = [self._as_set(kmv[i]) for i in range(kmv.shape[0])]
            hashes, theta = _eval_theta_set_expr(self.post_expr, sets)
            return len(hashes) / theta if theta > 0 else 0.0
        k = kmv.shape[-1]
        n_v = (kmv != _I64_MAX).sum(axis=-1)
        kth = kmv[..., -1].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            theta = kth / float(1 << 62)
            est = np.where(theta > 0, (n_v - 1) / theta, n_v)
        out = np.where(n_v < k, n_v, est)
        return out if kmv.ndim > 1 else out.item()

    @staticmethod
    def _as_set(row: np.ndarray):
        """KMV row -> (hashes STRICTLY below theta, theta in (0, 1]);
        a saturated sketch drops its theta-defining Kth hash."""
        valid = row[row != _I64_MAX]
        if len(valid) < len(row):
            return valid, 1.0  # unsaturated: the COMPLETE distinct hash set
        return valid[:-1], float(valid[-1]) / float(1 << 62)


def _eval_theta_set_expr(expr: str, sets):
    """Evaluate SET_UNION/SET_INTERSECT/SET_DIFF over $i sketch refs; each
    operand is (sorted distinct hashes, theta).  Results truncate at theta =
    min of the operands' thetas; the estimate is |hashes| / theta."""
    s = expr.strip()
    m = re.fullmatch(r"\$(\d+)", s)
    if m:
        i = int(m.group(1)) - 1
        if not 0 <= i < len(sets):
            raise ValueError(f"theta set expression references ${i + 1}; only {len(sets)} filters")
        return sets[i]
    m = re.fullmatch(r"(SET_UNION|SET_INTERSECT|SET_DIFF)\s*\((.*)\)", s, re.IGNORECASE | re.DOTALL)
    if not m:
        raise ValueError(f"unsupported theta set expression {expr!r}")
    op = m.group(1).upper()
    # split args at top-level commas
    args, depth, start = [], 0, 0
    body = m.group(2)
    for j, ch in enumerate(body):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            args.append(body[start:j])
            start = j + 1
    args.append(body[start:])
    operands = [_eval_theta_set_expr(a, sets) for a in args]
    theta = min(t for _, t in operands)
    cut = int(theta * float(1 << 62))
    # hashes STRICTLY below theta take part; theta == 1.0 means every
    # operand is a complete set
    trimmed = [h[h < cut] if theta < 1.0 else h for h, _ in operands]
    if op == "SET_UNION":
        out = np.unique(np.concatenate(trimmed))
    elif op == "SET_INTERSECT":
        out = trimmed[0]
        for h in trimmed[1:]:
            out = out[np.isin(out, h)]
    else:  # SET_DIFF(a, b)
        if len(trimmed) != 2:
            raise ValueError("SET_DIFF takes exactly two operands")
        out = trimmed[0][~np.isin(trimmed[0], trimmed[1])]
    return out, theta


# ---------------------------------------------------------------------------
# MODE: value-offset histogram + argmax
# ---------------------------------------------------------------------------
class ModeFunction(AggFunction):
    """Most frequent value over a bounded int range; ties break to the
    SMALLEST value (Pinot's default MIN reducer)."""

    name = "mode"
    needs_codes = True
    needs_binding = True
    vector_fields = True
    input_kind = "values_offset"
    fields = ("hist", "lo")

    def __init__(self, domain: int = 0, base: int = 0):
        self.domain = domain
        self.base = base

    def bind_column(self, info: ColumnBinding) -> "ModeFunction":
        if info.kind == "rawint" or (
            info.min_value is not None
            and isinstance(info.min_value, (int, np.integer))
            and isinstance(info.max_value, (int, np.integer))
        ):
            base = int(info.min_value)
            return ModeFunction(domain=int(info.max_value) - base + 1, base=base)
        raise NotImplementedError(
            "MODE requires a bounded integer value range (int/long column with stats)"
        )

    def partial(self, codes, mask):
        _check_cell_budget(self.name, 1, self.domain)
        hist = ops.group_count(mask, masked_cells(mask, codes), self.domain)
        return {"hist": hist, "lo": torch.full((), float(self.base), dtype=torch.float64, device=mask.device)}

    def partial_grouped(self, codes, mask, keys, num_groups):
        _check_cell_budget(self.name, num_groups, self.domain)
        flat = masked_cells(mask, _flat_cells(keys, self.domain, codes))
        hist = ops.group_count(mask, flat, num_groups * self.domain).reshape(num_groups, self.domain)
        return {"hist": hist, "lo": torch.full((num_groups,), float(self.base), dtype=torch.float64, device=mask.device)}

    def merge(self, a, b):
        return {"hist": np.asarray(a["hist"]) + np.asarray(b["hist"]), "lo": np.minimum(a["lo"], b["lo"])}

    def final(self, p):
        hist = np.atleast_2d(np.asarray(p["hist"]))
        lo = np.atleast_1d(np.asarray(p["lo"], dtype=np.float64))
        # np.argmax takes the FIRST max — the lowest offset = smallest value
        best = np.argmax(hist, axis=1).astype(np.float64)
        out = np.where(hist.sum(axis=1) > 0, lo + best, np.nan)
        return out[0] if np.asarray(p["hist"]).ndim == 1 else out


# ---------------------------------------------------------------------------
# FIRST/LAST_WITH_TIME(value, timeCol, 'dataType')
# ---------------------------------------------------------------------------
def extreme_pair_merge(a_key, a_v, b_key, b_v, sign: float):
    """Pairwise merge of coupled (key, value) partials: take b where its
    sign * key is larger, or equal with a larger value.  numpy or torch."""
    tak, tav, tbk, tbv = (as_tensor(x).to(torch.float64) for x in (a_key, a_v, b_key, b_v))
    take_b = (tbk * sign > tak * sign) | ((tbk * sign == tak * sign) & (tbv > tav))
    return like_input(torch.where(take_b, tbk, tak), a_key), like_input(torch.where(take_b, tbv, tav), a_v)


def extreme_pair_grouped(v, key_signed, mask, keys, num_groups: int):
    """(per-group max of key_signed over masked rows, per-group max of v
    among the rows at that max) — the (t, v) / (m, v) pair tables."""
    dev = mask.device
    ninf = torch.full((), float("-inf"), dtype=torch.float64, device=dev)
    k = keys.to(torch.int64)
    kmax = torch.full((num_groups,), float("-inf"), dtype=torch.float64, device=dev).scatter_reduce_(
        0, k, torch.where(mask, key_signed, ninf), reduce="amax", include_self=True
    )
    best = mask & (key_signed == kmax[k])
    vbest = torch.full((num_groups,), float("-inf"), dtype=torch.float64, device=dev).scatter_reduce_(
        0, k, torch.where(best, v, ninf), reduce="amax", include_self=True
    )
    return kmax, vbest


class LastWithTimeFunction(AggFunction):
    """Value at the max (LAST) / min (FIRST) time.  values arrives as the
    tuple (v, t) via AggregationSpec.extra_exprs; ties on t take the max v.
    Partials merge pairwise by time."""

    name = "lastwithtime"
    needs_extra_exprs = True
    vector_fields = True  # keep off the generic sparse field paths
    pairwise_merge = True
    fields = ("t", "v")
    pick_last = True

    def _prep(self, values, mask):
        v, t = values[0], values[1]
        sign = 1.0 if self.pick_last else -1.0
        ninf = torch.full((), float("-inf"), dtype=torch.float64, device=mask.device)
        tt = torch.where(mask, t.to(torch.float64) * sign, ninf)
        return v.to(torch.float64), tt, sign

    def partial(self, values, mask):
        v, tt, sign = self._prep(values, mask)
        tmax = torch.max(tt)
        best = mask & (tt == tmax)
        vbest = torch.max(torch.where(best, v, torch.full((), float("-inf"), dtype=torch.float64, device=v.device)))
        return {"t": tmax * sign, "v": vbest}

    def partial_grouped(self, values, mask, keys, num_groups):
        v, tt, sign = self._prep(values, mask)
        tmax, vbest = extreme_pair_grouped(v, tt, mask, keys, num_groups)
        return {"t": tmax * sign, "v": vbest}

    def merge(self, a, b):
        t, v = extreme_pair_merge(a["t"], a["v"], b["t"], b["v"], 1.0 if self.pick_last else -1.0)
        return {"t": t, "v": v}

    def final(self, p):
        v = np.asarray(p["v"], dtype=np.float64)
        t = np.asarray(p["t"], dtype=np.float64)
        return np.where(np.isfinite(t), v, np.nan)


class FirstWithTimeFunction(LastWithTimeFunction):
    name = "firstwithtime"
    pick_last = False


class FrequentLongsFunction(ModeFunction):
    """Top-k most frequent values over a bounded int range (exact over the
    value-offset histogram).  A list of values, most frequent first (ties:
    smaller value)."""

    name = "frequentlongs"

    def __init__(self, domain: int = 0, base: int = 0, k: int = 10):
        super().__init__(domain=domain, base=base)
        self.k = k

    def with_args(self, literal_args):
        k = int(literal_args[0]) if literal_args else 10
        return FrequentLongsFunction(k=k)

    def bind_column(self, info: ColumnBinding):
        bound = ModeFunction.bind_column(self, info)
        return FrequentLongsFunction(domain=bound.domain, base=bound.base, k=self.k)

    def final(self, p):
        hist = np.atleast_2d(np.asarray(p["hist"]))
        lo = np.atleast_1d(np.asarray(p["lo"], dtype=np.int64))
        out = np.empty(hist.shape[0], dtype=object)
        for g in range(hist.shape[0]):
            nz = np.nonzero(hist[g])[0]
            top = nz[np.argsort(-hist[g][nz], kind="stable")][: self.k]
            out[g] = [int(lo[g] + o) for o in top]
        return out[0] if np.asarray(p["hist"]).ndim == 1 else out


# ---------------------------------------------------------------------------
# DISTINCTSUM / DISTINCTAVG: sum/avg over the DISTINCT values
# ---------------------------------------------------------------------------
class DistinctSumFunction(ModeFunction):
    """Sum of distinct values over a bounded int range: the sum over
    present offsets of (lo + offset)."""

    name = "distinctsum"

    def bind_column(self, info: ColumnBinding):
        bound = super().bind_column(info)
        return DistinctSumFunction(domain=bound.domain, base=bound.base)

    def final(self, p):
        hist = np.atleast_2d(np.asarray(p["hist"]))
        lo = np.atleast_1d(np.asarray(p["lo"], dtype=np.float64))
        offsets = np.arange(hist.shape[1], dtype=np.float64)
        out = ((hist > 0) * (lo[:, None] + offsets[None, :])).sum(axis=1)
        return out[0] if np.asarray(p["hist"]).ndim == 1 else out


class DistinctAvgFunction(DistinctSumFunction):
    name = "distinctavg"

    def bind_column(self, info: ColumnBinding):
        bound = ModeFunction.bind_column(self, info)
        return DistinctAvgFunction(domain=bound.domain, base=bound.base)

    def final(self, p):
        hist = np.atleast_2d(np.asarray(p["hist"]))
        s = np.atleast_1d(DistinctSumFunction.final(self, p))
        n = (hist > 0).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(n > 0, s / n, np.nan)
        return out[0] if np.asarray(p["hist"]).ndim == 1 else out


# ---------------------------------------------------------------------------
# Multi-value aggregations: COUNTMV/SUMMV/MINMV/MAXMV/AVGMV/DISTINCTCOUNTMV
# ---------------------------------------------------------------------------
class MVAggFunction(AggFunction):
    """Wraps a single-value aggregation to run over every ELEMENT of an MV
    column (reference: SumMVAggregationFunction et al).  The planner hands
    the padded [rows, max_len] value/code matrix with a combined row and
    length mask; partials flatten and delegate, grouped keys broadcast
    along the element axis, so one row's elements all land in its group."""

    mv_input = True
    field_kinds = None
    vector_fields = True  # 2-D inputs take the function's own tables

    def __init__(self, base: AggFunction):
        self.base = base
        self.name = base.name + "mv"
        self.fields = base.fields
        self.needs_codes = base.needs_codes
        self.needs_binding = base.needs_binding
        self.pairwise_merge = base.pairwise_merge

    def with_args(self, literal_args):
        return MVAggFunction(self.base.with_args(literal_args))

    def bind_column(self, info):
        return MVAggFunction(self.base.bind_column(info))

    def partial(self, values, mask):
        return self.base.partial(values.reshape(-1), mask.reshape(-1))

    def partial_grouped(self, values, mask, keys, num_groups):
        n, m = mask.shape
        k2 = keys[:, None].expand(n, m).reshape(-1)
        return self.base.partial_grouped(values.reshape(-1), mask.reshape(-1), k2, num_groups)

    def host_partial(self, p):
        return self.base.host_partial(p)

    def merge(self, a, b):
        return self.base.merge(a, b)

    def final(self, p):
        return self.base.final(p)


for _cls in (
    PercentileLogSketchFunction,
    DistinctCountThetaFunction,
    ModeFunction,
    FrequentLongsFunction,
    DistinctSumFunction,
    DistinctAvgFunction,
    LastWithTimeFunction,
    FirstWithTimeFunction,
):
    register(_cls())

for _base_name in ("count", "sum", "min", "max", "avg", "distinctcount"):
    register(MVAggFunction(get_agg_function(_base_name)))

# aliases matching the reference's surface
_REGISTRY["distinctcountrawtheta"] = _REGISTRY["distinctcounttheta"]
_REGISTRY["distinctcountbitmap"] = _REGISTRY["distinctcount"]
