"""Filter compilation: predicate tree -> mask computation on torch tensors.

Port of pinot_tpu/query/filter.py (the single-table slice's subset).
Predicates on dictionary columns resolve AGAINST THE SORTED DICTIONARY on the
host, then evaluate on the device as
  - a closed-form code-range compare (EQ/RANGE -> lo <= code < hi), or
  - a boolean lookup table gathered by code (IN/NOT_IN/NEQ/LIKE/REGEXP);
and, where an index answers them, as
  - a sorted column's doc range (two int params, zero row reads),
  - a range index's prefix[hi] & ~prefix[lo] words, or
  - an OR of inverted-index rows,
resolved host-side and shipped as packed words (int32 views) that unpack on
the device.  Raw numeric columns compare values directly.  AND/OR/NOT are
mask algebra with SQL three-valued logic: each node yields (true_mask,
null_mask); rows are selected iff truly true.

Per-segment constants ride a params dict (numpy on the host, tensors on the
device at launch), so equal-shaped segments and queries that differ only
in literals share one planned closure.  Closures take (cols, params, dev):
eager torch needs the device for masks that read no column.  Transforms
over columns (function calls in predicates or aggregation inputs) are a
later slice of the port.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.ops.segmented import unpack_bitmap_words
from pinot_tpu_torch.query.ir import Expr, FilterNode, FilterOp, Predicate, PredicateType
from pinot_tpu_torch.segment.segment import ImmutableSegment

# (true_mask, null_mask|None)
MaskPair = Tuple[torch.Tensor, Optional[torch.Tensor]]
Params = Dict[str, np.ndarray]

# IN/NOT_IN/regex tables resolve through the inverted index only up to this
# many bitmap-row ORs (past it a code scan reads less)
_INV_MAX_ROWS = 256


def like_to_regex(pattern: str) -> str:
    """SQL LIKE -> anchored regex (Pinot LikeToRegexpLikePatternConverter)."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def or_masks(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def column_values(name: str, segment: ImmutableSegment, cols: Dict) -> MaskPair:
    """Numeric values of a column from its device entry (a dictionary gather
    for dict-encoded numerics) and its null mask."""
    c = segment.column(name)
    entry = cols[name]
    if c.data_type.is_string_like:
        raise ValueError(
            f"column {name!r} is {c.data_type.value}; string values never materialize on device "
            "(use it in predicates/group-by, which operate on dict codes)"
        )
    if "values" in entry:
        vals = entry["values"]
    else:
        vals = entry["dict"][entry["codes"].to(torch.int64)]
    return vals, entry.get("nulls")


def eval_column(expr: Expr, segment: ImmutableSegment, cols: Dict) -> MaskPair:
    """(values, nulls) of a bare column expression."""
    if not expr.is_column:
        raise NotImplementedError(
            f"expression {expr} needs the transform layer, a later slice of the port"
        )
    return column_values(expr.op, segment, cols)


def _promoted(vals: torch.Tensor, p: torch.Tensor):
    """Both operands in their promoted dtype: torch keeps a tensor's dtype
    against a 0-dim operand of the same kind, which would wrap an int64
    literal compared with an int32 column."""
    dt = torch.promote_types(vals.dtype, p.dtype)
    return vals.to(dt), p.to(dt)


class FilterCompiler:
    """Compiles one filter tree against one segment.

    Produces (a) a params dict of per-segment constants and (b) an eval
    closure over (cols, params, dev).  Param keys follow traversal order, so
    segments with the same query shape produce structurally identical
    params.  `used_columns` names the columns the closures read (columns
    touched only by index-resolved predicates never ship to the device);
    `index_uses` records (column, kind) per index-accelerated predicate."""

    def __init__(self, segment: ImmutableSegment, null_handling: bool = True):
        self.segment = segment
        self.null_handling = null_handling
        self.params: Params = {}
        self._counter = 0
        self.used_columns = set()
        self.index_uses: List[Tuple[str, str]] = []

    def _key(self, suffix: str) -> str:
        k = f"f{self._counter}.{suffix}"
        self._counter += 1
        return k

    def _col_index(self, kind: str, name: str):
        return self.segment.indexes.get(kind, {}).get(name)

    # ------------------------------------------------------------------
    def compile(self, node: Optional[FilterNode]) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        if node is None:
            n = self.segment.num_docs

            def match_all(cols, params, dev):
                return torch.ones((n,), dtype=torch.bool, device=dev), None

            return match_all
        return self._compile_node(node)

    def _compile_node(self, node: FilterNode) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        if node.op is FilterOp.PRED:
            return self._compile_predicate(node.predicate)
        children = [self._compile_node(c) for c in node.children]
        if node.op is FilterOp.AND:

            def eval_and(cols, params, dev):
                t, nl = children[0](cols, params, dev)
                for c in children[1:]:
                    t2, n2 = c(cols, params, dev)
                    # null = at least one null, no false (3VL).  As in the
                    # JAX package, a child without a null mask counts as
                    # never-false here (its `false` term is empty)
                    if nl is None and n2 is None:
                        t = t & t2
                        continue
                    f1 = None if nl is None else ~t & ~nl
                    f2 = None if n2 is None else ~t2 & ~n2
                    nl = or_masks(nl, n2)
                    for f in (f1, f2):
                        if f is not None:
                            nl = nl & ~f
                    t = t & t2
                return t, nl

            return eval_and
        if node.op is FilterOp.OR:

            def eval_or(cols, params, dev):
                t, nl = children[0](cols, params, dev)
                for c in children[1:]:
                    t2, n2 = c(cols, params, dev)
                    t = t | t2
                    nl = or_masks(nl, n2)
                if nl is not None:
                    nl = nl & ~t
                return t, nl

            return eval_or
        if node.op is FilterOp.NOT:

            def eval_not(cols, params, dev):
                t, nl = children[0](cols, params, dev)
                if nl is None:
                    return ~t, None
                return ~t & ~nl, nl

            return eval_not
        raise ValueError(f"unknown filter op {node.op}")

    # ------------------------------------------------------------------
    def _compile_predicate(self, p: Predicate) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        seg = self.segment
        if p.ptype in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
            if not p.lhs.is_column:
                raise ValueError("IS [NOT] NULL requires a bare column")
            col = seg.column(p.lhs.op)
            want_null = p.ptype is PredicateType.IS_NULL
            has_nulls = col.nulls is not None and self.null_handling
            if has_nulls:
                self.used_columns.add(p.lhs.op)
            n = seg.num_docs

            def eval_null(cols, params, dev, _want=want_null, _has=has_nulls, _name=p.lhs.op):
                if not _has:
                    fill = torch.zeros if _want else torch.ones
                    return fill((n,), dtype=torch.bool, device=dev), None
                nulls = cols[_name]["nulls"]
                return (nulls if _want else ~nulls), None

            return eval_null
        if p.ptype in (PredicateType.TEXT_MATCH, PredicateType.JSON_MATCH, PredicateType.VECTOR_SIMILARITY):
            raise NotImplementedError(
                f"{p.ptype.value} needs JSON/text/vector indexes, a later slice of the port"
            )
        if not p.lhs.is_column:
            raise NotImplementedError(
                f"predicate over expression {p.lhs} needs the transform layer, a later slice of the port"
            )
        if seg.column(p.lhs.op).has_dictionary:
            return self._compile_dict_predicate(p)
        return self._compile_value_predicate(p)

    # -- dictionary-based ------------------------------------------------
    def _compile_dict_predicate(self, p: Predicate) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        name = p.lhs.op
        col = self.segment.column(name)
        d = col.dictionary
        card = d.cardinality
        values = d.values
        pt = p.ptype

        lo_code = hi_code = None
        table: Optional[np.ndarray] = None

        if pt is PredicateType.EQ:
            i = d.index_of(p.values[0])
            lo_code, hi_code = (i, i + 1) if i >= 0 else (0, 0)
        elif pt is PredicateType.NEQ:
            i = d.index_of(p.values[0])
            table = np.ones(card, dtype=bool)
            if i >= 0:
                table[i] = False
        elif pt is PredicateType.RANGE:
            lo_code = 0
            hi_code = card
            # raw literals into searchsorted: numpy's cross-dtype compare keeps
            # 2.5 between 2 and 3 on an INT dictionary (no truncation).
            if p.lower is not None:
                lo_code = int(np.searchsorted(values, p.lower, side="left" if p.lower_inclusive else "right"))
            if p.upper is not None:
                hi_code = int(np.searchsorted(values, p.upper, side="right" if p.upper_inclusive else "left"))
        elif pt in (PredicateType.IN, PredicateType.NOT_IN):
            table = np.zeros(card, dtype=bool)
            for v in p.values:
                i = d.index_of(v)
                if i >= 0:
                    table[i] = True
            if pt is PredicateType.NOT_IN:
                table = ~table
        elif pt in (PredicateType.REGEXP_LIKE, PredicateType.LIKE):
            pat = p.values[0]
            rx = re.compile(pat if pt is PredicateType.REGEXP_LIKE else like_to_regex(pat))
            # regex over the dictionary, not the rows — card evaluations total.
            table = np.fromiter((rx.search(str(v)) is not None for v in values), dtype=bool, count=card)
        else:
            raise ValueError(f"predicate {pt} not supported on dictionary column {name}")

        has_nulls = col.nulls is not None and self.null_handling

        accel = self._try_index_paths(name, col, lo_code, hi_code, table, has_nulls)
        if accel is not None:
            return accel

        if table is not None:
            key = self._key("table")
            self.params[key] = table
            self.used_columns.add(name)

            def eval_table(cols, params, dev, _key=key, _name=name, _has=has_nulls):
                t = params[_key][cols[_name]["codes"].to(torch.int64)]
                nulls = cols[_name].get("nulls") if _has else None
                if nulls is not None:
                    t = t & ~nulls
                return t, nulls

            return eval_table

        lo_key = self._key("lo")
        hi_key = self._key("hi")
        self.params[lo_key] = np.int32(lo_code)
        self.params[hi_key] = np.int32(hi_code)
        self.used_columns.add(name)

        def eval_range(cols, params, dev, _lo=lo_key, _hi=hi_key, _name=name, _has=has_nulls):
            codes = cols[_name]["codes"].to(torch.int32)
            t = (codes >= params[_lo]) & (codes < params[_hi])
            nulls = cols[_name].get("nulls") if _has else None
            if nulls is not None:
                t = t & ~nulls
            return t, nulls

        return eval_range

    # -- index-accelerated predicate compilation -------------------------
    def _null_guard(self, name: str, has_nulls: bool):
        if has_nulls:
            self.used_columns.add(name)

    def _emit_doc_range(self, name: str, d0: int, d1: int, has_nulls: bool):
        n = self.segment.num_docs
        lo_key = self._key("d0")
        hi_key = self._key("d1")
        self.params[lo_key] = np.int32(d0)
        self.params[hi_key] = np.int32(d1)
        self._null_guard(name, has_nulls)
        self.index_uses.append((name, "sorted"))

        def eval_docrange(cols, params, dev, _lo=lo_key, _hi=hi_key, _name=name, _has=has_nulls):
            docs = torch.arange(n, dtype=torch.int32, device=dev)
            t = (docs >= params[_lo]) & (docs < params[_hi])
            nulls = cols[_name].get("nulls") if _has else None
            if nulls is not None:
                t = t & ~nulls
            return t, nulls

        return eval_docrange

    def _emit_bitmap(self, name: str, words: np.ndarray, kind: str, has_nulls: bool, negate: bool):
        n = self.segment.num_docs
        key = self._key("bits")
        self.params[key] = np.ascontiguousarray(words, dtype=np.uint32)
        self._null_guard(name, has_nulls)
        self.index_uses.append((name, kind))

        def eval_bitmap(cols, params, dev, _key=key, _name=name, _has=has_nulls, _neg=negate):
            t = unpack_bitmap_words(params[_key], n)
            if _neg:
                t = ~t
            nulls = cols[_name].get("nulls") if _has else None
            if nulls is not None:
                t = t & ~nulls
            return t, nulls

        return eval_bitmap

    def _try_index_paths(self, name, col, lo_code, hi_code, table, has_nulls):
        """Sorted doc-range > range-index > inverted-index, else None (scan)."""
        if lo_code is not None:  # code-range predicate (EQ / RANGE)
            if col.stats.is_sorted and col.codes is not None:
                codes_arr = np.asarray(col.codes)
                d0 = int(np.searchsorted(codes_arr, lo_code, side="left"))
                d1 = int(np.searchsorted(codes_arr, hi_code, side="left")) if hi_code > lo_code else d0
                return self._emit_doc_range(name, d0, d1, has_nulls)
            return self._try_bitmap_range(name, col, lo_code, hi_code, has_nulls)
        # table predicate (IN / NOT_IN / NEQ / regex / LIKE)
        inv = self._col_index("inverted", name)
        if inv is None:
            return None
        pos = np.nonzero(table)[0]
        neg_ids = np.nonzero(~table)[0]
        if len(pos) <= _INV_MAX_ROWS:
            words = inv.doc_bitmap(pos) if len(pos) else np.zeros(inv.num_words, np.uint32)
            return self._emit_bitmap(name, words, "inverted", has_nulls, False)
        if len(neg_ids) <= _INV_MAX_ROWS:
            words = inv.doc_bitmap(neg_ids) if len(neg_ids) else np.zeros(inv.num_words, np.uint32)
            return self._emit_bitmap(name, words, "inverted", has_nulls, True)
        return None

    def _try_bitmap_range(self, name, col, lo_code, hi_code, has_nulls):
        """Range-index / inverted-index resolution for a code-range predicate."""
        rng_idx = self._col_index("range", name)
        if rng_idx is not None:
            return self._emit_bitmap(
                name, rng_idx.range_bitmap(lo_code, hi_code), "range", has_nulls, False
            )
        inv = self._col_index("inverted", name)
        if inv is not None and (hi_code - lo_code) <= _INV_MAX_ROWS:
            ids = np.arange(lo_code, hi_code, dtype=np.int64)
            words = inv.doc_bitmap(ids) if len(ids) else np.zeros(inv.num_words, np.uint32)
            return self._emit_bitmap(name, words, "inverted", has_nulls, False)
        return None

    # -- raw-value -------------------------------------------------------
    def _compile_value_predicate(self, p: Predicate) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        from pinot_tpu_torch.query.shape import bucket_size

        seg = self.segment
        pt = p.ptype
        if pt in (PredicateType.REGEXP_LIKE, PredicateType.LIKE):
            raise ValueError(f"{pt.value} requires a dictionary-encoded column (lhs={p.lhs})")
        null_handling = self.null_handling
        self.used_columns.add(p.lhs.op)

        if pt in (PredicateType.IN, PredicateType.NOT_IN):
            key = self._key("set")
            vals_arr = np.asarray(sorted(p.values))
            # numeric lists: normalized dtype, padded to the bucketed size
            # class with identity fill (repeating a member never changes isin)
            if np.issubdtype(vals_arr.dtype, np.integer):
                vals_arr = vals_arr.astype(np.int64)
            elif np.issubdtype(vals_arr.dtype, np.floating):
                vals_arr = vals_arr.astype(np.float64)
            if vals_arr.dtype.kind in "iuf" and len(vals_arr):
                b = bucket_size(len(vals_arr))
                if b > len(vals_arr):
                    fill = np.full(b - len(vals_arr), vals_arr[0], vals_arr.dtype)
                    vals_arr = np.concatenate([vals_arr, fill])
            self.params[key] = vals_arr

            def eval_in(cols, params, dev, _key=key, _neg=(pt is PredicateType.NOT_IN)):
                vals, nulls = eval_column(p.lhs, seg, cols)
                t = torch.isin(*_promoted(vals, params[_key]))
                if _neg:
                    t = ~t
                if nulls is not None and null_handling:
                    return t & ~nulls, nulls
                return t, None

            return eval_in

        # raw EQ/NEQ/RANGE: numeric literals ship as scalar params, so
        # distinct literals reuse one planned closure
        def _num_param(suffix: str, v):
            if not isinstance(v, (bool, int, float)):
                raise ValueError(f"raw column {p.lhs.op} compares with numeric literals only, got {v!r}")
            key = self._key(suffix)
            if isinstance(v, bool):
                self.params[key] = np.bool_(v)
            elif isinstance(v, int):
                self.params[key] = np.int64(v)
            else:
                self.params[key] = np.float64(v)
            return key

        eq_key = lo_key = hi_key = None
        if pt in (PredicateType.EQ, PredicateType.NEQ):
            eq_key = _num_param("cmp", p.values[0])
        elif pt is PredicateType.RANGE:
            if p.lower is not None:
                lo_key = _num_param("lo", p.lower)
            if p.upper is not None:
                hi_key = _num_param("hi", p.upper)
        else:
            raise ValueError(f"predicate {pt} unsupported on raw values")

        def eval_cmp(cols, params, dev):
            vals, nulls = eval_column(p.lhs, seg, cols)
            if pt is PredicateType.EQ:
                a, b = _promoted(vals, params[eq_key])
                t = a == b
            elif pt is PredicateType.NEQ:
                a, b = _promoted(vals, params[eq_key])
                t = a != b
            else:
                t = torch.ones_like(vals, dtype=torch.bool)
                if lo_key is not None:
                    a, lo = _promoted(vals, params[lo_key])
                    t = t & (a >= lo if p.lower_inclusive else a > lo)
                if hi_key is not None:
                    a, hi = _promoted(vals, params[hi_key])
                    t = t & (a <= hi if p.upper_inclusive else a < hi)
            if nulls is not None and null_handling:
                return t & ~nulls, nulls
            return t, None

        return eval_cmp
