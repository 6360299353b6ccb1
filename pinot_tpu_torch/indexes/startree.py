"""Star-tree index: a ladder of pre-aggregated prefix levels.

Port of pinot_tpu/indexes/startree.py.  Reference parity: Pinot's
StarTreeV2 (pinot-segment-spi/.../spi/index/startree/StarTreeV2.java,
builder OffHeapSingleTreeBuilder, runtime StarTreeFilterOperator and the
StarTree aggregation/group-by executors).

As in the JAX package the tree is a LADDER OF COLLAPSED TABLES: for every
prefix length k of the dimension split order, level k holds the distinct
(d1..dk) combos of the segment, sorted, with pre-aggregated partial FIELDS
(count, and sum/sumsq/min/max per metric column).  A query whose filter and
group columns fall in the first k dimensions answers from level k
(query/startree.py).  Level dimension columns carry the PARENT segment's
dictionary codes (or raw integer values), so star results and raw-scan
results from other segments merge in one key space.

Where the JAX package builds the levels with numpy (`np.unique(axis=0)`
over an [n, k] code matrix and numpy scatters), the port builds them with
torch on the host, where the segment builder builds everything else: the
rows sort lexicographically by the split-order dimensions (one stable sort a
dimension, last dimension first), a combo starts where any dimension
changes, and the fields combine with ``index_add_`` / ``scatter_reduce_``.
The levels come out row for row equal to the JAX build (the same
lexicographic order, the same field dtypes: int64 counts and integer sums,
float64 sums of squares, float sums, min and max), so the on-disk regions
are shared: ``{prefix}.L{k}.d.{dim}`` and ``{prefix}.L{k}.f.{col}:{kind}``.
At query time a level's tables are an entry of the parent segment's device
cache (``ImmutableSegment.to_device`` with ``star_entry(tree, k)``), charged
and evicted with the segment's columns.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.segment.stats import ColumnStats

_F64 = torch.float64


def scatter_combine(kind: str, inverse: torch.Tensor, vals: torch.Tensor, n_groups: int) -> torch.Tensor:
    """One (count|sum|sumsq|min|max) scatter-aggregate into n_groups slots,
    the JAX package's single combine rule: additive integer kinds (not
    sumsq) add exactly in int64, the other additive kinds in float64,
    min/max in float64 with +-inf identities.  `vals` is taken as is
    (callers square before passing sumsq of raw rows)."""
    dev = vals.device
    if kind in ("count", "sum", "sumsq"):
        if not vals.is_floating_point() and vals.dtype != torch.bool and kind != "sumsq":
            return torch.zeros(n_groups, dtype=torch.int64, device=dev).index_add_(0, inverse, vals.to(torch.int64))
        return torch.zeros(n_groups, dtype=_F64, device=dev).index_add_(0, inverse, vals.to(_F64))
    if kind in ("min", "max"):
        ident = float("inf") if kind == "min" else float("-inf")
        return torch.full((n_groups,), ident, dtype=_F64, device=dev).scatter_reduce_(
            0, inverse, vals.to(_F64), reduce="amin" if kind == "min" else "amax", include_self=True
        )
    raise ValueError(f"unknown star-tree field kind {kind!r}")


def _parse_pairs(pairs: List[Any]) -> List[Tuple[str, str]]:
    """functionColumnPairs: "SUM__lo_revenue" strings or [func, col] lists."""
    out = []
    for p in pairs:
        if isinstance(p, str):
            func, _, col = p.partition("__")
        else:
            func, col = p
        out.append((func.lower(), col))
    return out


def _combo_starts(dims: List[torch.Tensor], n: int, dev: torch.device) -> torch.Tensor:
    """bool[n] over lexicographically sorted rows: True where a new combo of
    `dims` starts (row 0, and wherever any dimension changes)."""
    starts = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        starts[0] = True
    for a in dims:
        starts[1:] |= a[1:] != a[:-1]
    return starts


class StarTreeIndex:
    KIND = "startree"

    def __init__(
        self,
        split_order: List[str],
        pairs: List[Tuple[str, str]],
        levels: Dict[int, "StarLevel"],
        total_docs: int,
    ):
        self.split_order = list(split_order)
        self.pairs = [(f.lower(), c) for f, c in pairs]
        self.levels = levels
        self.total_docs = total_docs
        # (col, kind) set actually stored (from any level's fields)
        any_level = next(iter(levels.values()))
        self.stored: frozenset = frozenset(any_level.fields)

    # ------------------------------------------------------------------
    @staticmethod
    def build(
        columns: Dict[str, Any],
        num_docs: int,
        split_order: List[str],
        function_column_pairs: List[Any],
        min_collapse: float = 1.1,
    ) -> Optional["StarTreeIndex"]:
        """Build the level ladder from a segment's columns (on the host).

        Returns None (tree not worth it / not buildable) when a dimension
        or metric column has nulls, a metric is non-numeric, a function has
        no scalar fields, or the finest level collapses rows by less than
        `min_collapse`x — the JAX package's rules."""
        from pinot_tpu_torch.query.functions import get_agg_function

        dev = torch.device("cpu")
        pairs = _parse_pairs(function_column_pairs)

        # dimension columns: parent dictionary codes, or raw ints as they are
        dim_host: List[np.ndarray] = []
        for d in split_order:
            c = columns.get(d)
            if c is None or c.nulls is not None:
                return None
            if c.codes is not None:
                dim_host.append(np.asarray(c.codes))
            elif c.values is not None and np.issubdtype(np.asarray(c.values).dtype, np.integer):
                dim_host.append(np.asarray(c.values))
            else:
                return None

        # metric field columns to aggregate: (col, kind) -> source values
        need: Dict[Tuple[str, str], np.ndarray] = {}
        for func, col in pairs:
            if col == "*":
                continue
            c = columns.get(col)
            if c is None or c.nulls is not None:
                return None
            vals = np.asarray(c.decoded())
            if not np.issubdtype(vals.dtype, np.number):
                return None
            fn = get_agg_function(func)
            if fn.field_kinds is None:
                return None  # sketch family: not pre-aggregable as scalars
            for kind in fn.field_kinds.values():
                if kind != "count":
                    need[(col, kind)] = vals

        def to_dev(a: np.ndarray) -> torch.Tensor:
            a = np.ascontiguousarray(a)
            if a.dtype in (np.uint16, np.uint32):
                a = a.astype(np.int64)
            return torch.from_numpy(a if a.flags.writeable else a.copy())

        # finest level: rows sorted lexicographically by the split order
        dims = [to_dev(a).to(torch.int64) for a in dim_host]
        perm = torch.arange(num_docs, device=dev)
        for a in reversed(dims):
            perm = perm[torch.sort(a[perm], stable=True).indices]
        sorted_dims = [a[perm] for a in dims]
        starts = _combo_starts(sorted_dims, num_docs, dev)
        group_of_sorted = torch.cumsum(starts.to(torch.int64), 0) - 1
        n_g = int(group_of_sorted[-1].item()) + 1 if num_docs else 0
        if n_g * min_collapse > num_docs:
            return None  # barely collapses: scanning raw rows is as cheap
        inverse = torch.empty(num_docs, dtype=torch.int64, device=dev)
        inverse[perm] = group_of_sorted
        combos = [a[starts] for a in sorted_dims]

        fields: Dict[Tuple[str, str], torch.Tensor] = {
            ("*", "count"): torch.bincount(inverse, minlength=n_g).to(torch.int64)
        }
        on_dev: Dict[str, torch.Tensor] = {}
        for (col, kind), vals in need.items():
            if col not in on_dev:
                on_dev[col] = to_dev(vals)
            v = on_dev[col]
            src = v.to(_F64) ** 2 if kind == "sumsq" else v
            fields[(col, kind)] = scatter_combine(kind, inverse, src, n_g)

        K = len(split_order)
        level_t: Dict[int, Tuple[List[torch.Tensor], Dict[Tuple[str, str], torch.Tensor]]] = {K: (combos, fields)}
        # coarser levels: aggregate the next-finer level (adds add, mins min);
        # its rows are sorted, so a prefix's combos are consecutive
        cur, cur_fields = combos, fields
        for k in range(K - 1, -1, -1):
            m_rows = int(cur[0].shape[0]) if cur else n_g
            st = _combo_starts(cur[:k], m_rows, dev)
            inv2 = torch.cumsum(st.to(torch.int64), 0) - 1
            m = int(st.sum().item())
            sub = [a[st] for a in cur[:k]]
            f2 = {key: scatter_combine(key[1], inv2, arr, m) for key, arr in cur_fields.items()}
            level_t[k] = (sub, f2)
            cur, cur_fields = sub, f2

        levels = {
            k: StarLevel(
                num_rows=int(fl[("*", "count")].shape[0]),
                dims={d: a.numpy() for d, a in zip(split_order[:k], ds)},
                fields={key: arr.numpy() for key, arr in fl.items()},
            )
            for k, (ds, fl) in sorted(level_t.items(), reverse=True)
        }
        return StarTreeIndex(split_order, pairs, levels, num_docs)

    # -- persistence (segment/store.py region protocol) ------------------
    def to_regions(self, prefix: str) -> List[Tuple[str, np.ndarray]]:
        regions = []
        for k, lvl in self.levels.items():
            for d, arr in lvl.dims.items():
                regions.append((f"{prefix}.L{k}.d.{d}", arr))
            for (col, kind), arr in lvl.fields.items():
                regions.append((f"{prefix}.L{k}.f.{col}:{kind}", arr))
        return regions

    def meta(self) -> Dict[str, Any]:
        return {
            "splitOrder": self.split_order,
            "pairs": [[f, c] for f, c in self.pairs],
            "levels": {str(k): lvl.num_rows for k, lvl in self.levels.items()},
            "fields": [[c, k] for c, k in sorted(self.stored)],
            "totalDocs": self.total_docs,
        }

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str) -> "StarTreeIndex":
        split_order = meta["splitOrder"]
        levels: Dict[int, StarLevel] = {}
        for ks, nrows in meta["levels"].items():
            k = int(ks)
            dims = {d: np.asarray(regions[f"{prefix}.L{k}.d.{d}"]) for d in split_order[:k]}
            fields = {(c, kd): np.asarray(regions[f"{prefix}.L{k}.f.{c}:{kd}"]) for c, kd in meta["fields"]}
            levels[k] = StarLevel(num_rows=nrows, dims=dims, fields=fields)
        return StarTreeIndex(split_order, [tuple(p) for p in meta["pairs"]], levels, meta["totalDocs"])

    # -- query-time API --------------------------------------------------
    def level_for(self, dims_used: set) -> Optional[int]:
        """Smallest prefix length covering dims_used, or None."""
        if not dims_used <= set(self.split_order):
            return None
        k = 0
        for i, d in enumerate(self.split_order):
            if d in dims_used:
                k = i + 1
        return k

    def has_fields(self, func: str, col: str) -> bool:
        from pinot_tpu_torch.query.functions import get_agg_function

        fn = get_agg_function(func)
        if fn.field_kinds is None or fn.needs_binding:
            return False
        for kind in fn.field_kinds.values():
            key = ("*", "count") if kind == "count" else (col, kind)
            if key not in self.stored:
                return False
        return True


class StarLevel:
    """One collapsed table: distinct prefix combos + aggregated fields, as
    host arrays (persistence, the facade's metadata, and the source of the
    level's entry in the parent segment's device cache)."""

    def __init__(
        self,
        num_rows: int,
        dims: Dict[str, np.ndarray],
        fields: Dict[Tuple[str, str], np.ndarray],
    ):
        self.num_rows = num_rows
        self.dims = dims
        self.fields = fields
        # parent segment -> its facade: the view's host arrays and stats are
        # O(rows of the level), so a query must not rebuild them
        self._facades: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def host_arrays(self, parent) -> Dict[Any, np.ndarray]:
        """The arrays of this level's device entry: {dim name | (col, kind):
        table}, and {(dim, "dict"): values} for each dimension the parent
        holds under a device-decodable dictionary (the filter's value
        tables read it)."""
        out: Dict[Any, np.ndarray] = {**self.dims, **self.fields}
        for d in self.dims:
            dic = parent.column(d).dictionary
            dv = dic.device_values() if dic is not None else None
            if dv is not None:
                out[(d, "dict")] = dv
        return out

    def facade(self, parent) -> "StarSegmentView":
        """Segment-shaped view over this level for the FilterCompiler and
        the group dimensions: dim columns carry the PARENT's dictionaries
        over the level's codes.  Built once per parent segment."""
        with self._lock:
            view = self._facades.get(parent)
        if view is None:
            view = StarSegmentView(self, parent)
            with self._lock:
                view = self._facades.setdefault(parent, view)
        return view


class StarSegmentView:
    """Duck-typed ImmutableSegment over one star level (dims only)."""

    def __init__(self, level: StarLevel, parent):
        from pinot_tpu_torch.segment.segment import ColumnData

        self.num_docs = level.num_rows
        self.schema = parent.schema
        self.indexes: Dict[str, Dict[str, Any]] = {}
        self.columns: Dict[str, ColumnData] = {}
        for name, arr in level.dims.items():
            pc = parent.column(name)
            is_sorted = bool(len(arr) < 2 or np.all(np.diff(arr) >= 0))
            if pc.has_dictionary:
                codes = arr.astype(np.min_scalar_type(max(1, pc.dictionary.cardinality - 1)))
                mn = pc.dictionary.get_values(np.array([arr.min()]))[0] if len(arr) else None
                mx = pc.dictionary.get_values(np.array([arr.max()]))[0] if len(arr) else None
                stats = ColumnStats(
                    name=name, data_type=pc.data_type, num_docs=level.num_rows,
                    cardinality=pc.dictionary.cardinality, min_value=mn, max_value=mx,
                    is_sorted=is_sorted, has_nulls=False, has_dictionary=True,
                )
                self.columns[name] = ColumnData(name, pc.data_type, pc.dictionary, codes, None, None, stats)
            else:
                vals = arr.astype(pc.values.dtype)
                stats = ColumnStats(
                    name=name, data_type=pc.data_type, num_docs=level.num_rows,
                    cardinality=len(np.unique(arr)),
                    min_value=arr.min() if len(arr) else None,
                    max_value=arr.max() if len(arr) else None,
                    is_sorted=is_sorted, has_nulls=False, has_dictionary=False,
                )
                self.columns[name] = ColumnData(name, pc.data_type, None, None, vals, None, stats)

    def column(self, name: str):
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"star level has no dimension column {name!r}") from None
