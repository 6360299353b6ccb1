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
eager torch needs the device for masks that read no column.  A predicate
over an expression evaluates it through the transform layer
(transform.eval_expr); one over a string function of a dictionary column
(UPPER(city) = 'SF') evaluates the function over the dictionary on the
host and looks the codes up in the resulting table.

Multi-value columns match a row when ANY element matches; TEXT_MATCH and
JSON_MATCH evaluate over the dictionary's values on the host (through the
segment's text/JSON index, or one built lazily and cached on the segment)
into a code table; VECTOR_SIMILARITY is a matrix-vector product and a
top-k threshold on the device (indexes/vector.py).

Macro-batch hooks (parallel/engine.py compiles against a _ShardView that
carries them): with `bitmap_layout` = (ndev, L, D // 32) bitmap words are
stored FULL in that shape and named in `row_sharded_params`, and the engine
slices the doc axis per launch; with `docs_fn` a sorted column's doc range
compares against the global flat doc ids of the launch's rows.
`sole_bitmap_param` names the one plain bitmap (not negated, no null guard)
when it is the whole root filter: the engine then hands its words straight
to the fused scan (`mask_words`) and no row mask is unpacked.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.indexes.jsonidx import JsonIndex
from pinot_tpu_torch.indexes.text import TextIndex
from pinot_tpu_torch.indexes.vector import parse_query_vector, similarity_mask
from pinot_tpu_torch.ops.segmented import unpack_bitmap_words
from pinot_tpu_torch.query import scalar
from pinot_tpu_torch.query.ir import FilterNode, FilterOp, Predicate, PredicateType
from pinot_tpu_torch.query.transform import eval_expr, or_masks
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


def _match_values(p, values: np.ndarray) -> np.ndarray:
    """Evaluate a predicate over a (derived) value array -> bool table.
    Used by derived-string predicates, where codes are NOT sort ranks of the
    derived values, so everything is a table lookup (no code ranges)."""
    pt = p.ptype
    if pt is PredicateType.EQ:
        return np.array([v == p.values[0] for v in values], dtype=bool)
    if pt is PredicateType.NEQ:
        return np.array([v != p.values[0] for v in values], dtype=bool)
    if pt in (PredicateType.IN, PredicateType.NOT_IN):
        s = set(p.values)
        t = np.array([v in s for v in values], dtype=bool)
        return ~t if pt is PredicateType.NOT_IN else t
    if pt is PredicateType.RANGE:
        t = np.ones(len(values), dtype=bool)
        if p.lower is not None:
            t &= np.array(
                [(v >= p.lower if p.lower_inclusive else v > p.lower) for v in values], dtype=bool
            )
        if p.upper is not None:
            t &= np.array(
                [(v <= p.upper if p.upper_inclusive else v < p.upper) for v in values], dtype=bool
            )
        return t
    if pt in (PredicateType.REGEXP_LIKE, PredicateType.LIKE):
        pat = p.values[0]
        rx = re.compile(pat if pt is PredicateType.REGEXP_LIKE else like_to_regex(pat))
        return np.array([rx.search(str(v)) is not None for v in values], dtype=bool)
    raise ValueError(f"predicate {pt} not supported on derived string values")


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
        # macro-batch launches: per-launch global doc ids (a params-dependent
        # closure, the batch offset being a param) and the full-words layout
        self.docs_fn = getattr(segment, "docs_fn", None)
        self.bitmap_layout: Optional[Tuple[int, int, int]] = getattr(segment, "bitmap_layout", None)
        # param keys whose leading axis is the device axis (sliced per launch)
        self.row_sharded_params: set = set()
        # bitmap param keys that are plain (not negated, no null guard)
        self._plain_bitmaps: set = set()
        # set when the ROOT filter is exactly one plain bitmap predicate
        self.sole_bitmap_param: Optional[str] = None
        self._root_compiled = False

    def _key(self, suffix: str) -> str:
        k = f"f{self._counter}.{suffix}"
        self._counter += 1
        return k

    def _col_index(self, kind: str, name: str):
        return self.segment.indexes.get(kind, {}).get(name)

    def _cache_index(self, kind: str, name: str, idx) -> None:
        """Cache a lazily built (text/json) index on the segment, so repeated
        queries pay the cardinality-sized build once."""
        self.segment.indexes.setdefault(kind, {})[name] = idx

    # ------------------------------------------------------------------
    def compile(self, node: Optional[FilterNode]) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        is_root = not self._root_compiled
        self._root_compiled = True
        if node is None:
            n = self.segment.num_docs

            def match_all(cols, params, dev):
                return torch.ones((n,), dtype=torch.bool, device=dev), None

            return match_all
        before_keys = set(self.params)
        fn = self._compile_node(node)
        if is_root and node.op is FilterOp.PRED:
            new_keys = set(self.params) - before_keys
            if len(new_keys) == 1 and next(iter(new_keys)) in self._plain_bitmaps:
                self.sole_bitmap_param = next(iter(new_keys))
        return fn

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
        if p.ptype is PredicateType.VECTOR_SIMILARITY:
            return self._compile_vector_predicate(p)
        if p.lhs.is_column and seg.column(p.lhs.op).has_dictionary:
            return self._compile_dict_predicate(p)
        if scalar.is_dict_fn_expr(p.lhs) and scalar.string_result(p.lhs):
            return self._compile_derived_string_predicate(p)
        return self._compile_value_predicate(p)

    def _compile_vector_predicate(self, p: Predicate) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        """VECTOR_SIMILARITY(col, queryVec, topK): one matrix-vector product
        over the embedding rows on the device and a threshold at the k-th
        best cosine score (indexes/vector.similarity_mask): exact top-k;
        ties at the k-th score admit extra rows."""
        if not p.lhs.is_column:
            raise ValueError("VECTOR_SIMILARITY requires a bare vector column")
        name = p.lhs.op
        vidx = self._col_index("vector", name)
        if vidx is None:
            raise ValueError(
                f"VECTOR_SIMILARITY requires a vector index on {name} (tableIndexConfig.vectorIndexColumns)"
            )
        q = vidx.normalize_query(parse_query_vector(p.values[0]))
        k = int(p.values[1]) if len(p.values) > 1 else 10
        key = self._key("qvec")
        self.params[key] = q
        self.used_columns.add(name)
        self.index_uses.append((name, "vector"))
        dim = vidx.dim

        def eval_vec(cols, params, dev, _key=key, _name=name, _k=k, _dim=dim):
            return similarity_mask(cols[_name]["values"], params[_key], _dim, _k), None

        return eval_vec

    def _compile_derived_string_predicate(self, p: Predicate) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        """Predicate over a string function of a dict column (WHERE
        UPPER(city) = 'SF'): the function evaluates over the dictionary's
        values on the host, the predicate over the derived values gives a
        code table, and the device work is one table[codes] lookup."""
        name = next(a for a in p.lhs.args if not a.is_literal).op
        col = self.segment.column(name)
        if not col.has_dictionary:
            raise ValueError(f"{p.lhs.op} predicate requires dictionary column, {name} is raw")
        table = _match_values(p, scalar.derived_for(p.lhs, col.dictionary))
        has_nulls = col.nulls is not None and self.null_handling
        key = self._key("dtable")
        self.params[key] = table
        self.used_columns.add(name)

        def eval_table(cols, params, dev, _key=key, _name=name, _has=has_nulls):
            t = params[_key][cols[_name]["codes"].to(torch.int64)]
            nulls = cols[_name].get("nulls") if _has else None
            if nulls is not None:
                t = t & ~nulls
            return t, nulls

        return eval_table

    # -- dictionary-based ------------------------------------------------
    def _compile_dict_predicate(self, p: Predicate) -> Callable[[Dict, Dict, torch.device], MaskPair]:
        name = p.lhs.op
        col = self.segment.column(name)
        d = col.dictionary
        card = d.cardinality
        values = d.values
        pt = p.ptype
        # Multi-value columns: a row matches when ANY element matches (the
        # reference's per-value MV predicate semantics).  The padded code
        # matrix evaluates elementwise, then any() over the element axis; the
        # padding code (== cardinality) must stay no-match, so code tables
        # get an explicit False pad slot — after NEQ/NOT_IN negation too —
        # and code ranges never reach it (hi <= cardinality)
        is_mv = col.is_multi_value

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
        elif pt is PredicateType.TEXT_MATCH:
            idx = self._col_index("text", name)
            if idx is None:
                idx = TextIndex.build(values)  # lazy: cardinality work, cached below
                self._cache_index("text", name, idx)
            else:
                self.index_uses.append((name, "text"))
            table = idx.match(str(p.values[0]))
        elif pt is PredicateType.JSON_MATCH:
            idx = self._col_index("json", name)
            if idx is None:
                idx = JsonIndex.build(values)
                self._cache_index("json", name, idx)
            else:
                self.index_uses.append((name, "json"))
            table = idx.match(str(p.values[0]))
        else:
            raise ValueError(f"predicate {pt} not supported on dictionary column {name}")

        has_nulls = col.nulls is not None and self.null_handling

        # index-accelerated paths (no code scan); never for MV columns
        if not is_mv:
            accel = self._try_index_paths(name, col, lo_code, hi_code, table, has_nulls)
            if accel is not None:
                return accel

        if table is not None:
            if is_mv:
                table = np.append(table, False)  # padding code slot
            key = self._key("table")
            self.params[key] = table
            self.used_columns.add(name)

            def eval_table(cols, params, dev, _key=key, _name=name, _has=has_nulls):
                t = params[_key][cols[_name]["codes"].to(torch.int64)]
                if t.dim() == 2:
                    t = t.any(dim=1)
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
            if t.dim() == 2:
                t = t.any(dim=1)
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
        docs_fn = self.docs_fn

        def eval_docrange(cols, params, dev, _lo=lo_key, _hi=hi_key, _name=name, _has=has_nulls):
            if docs_fn is not None:
                docs = docs_fn(params, dev)
            else:
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
        words = np.ascontiguousarray(words, dtype=np.uint32)
        if self.bitmap_layout is not None:
            # macro-batch engine: FULL words as [ndev, L, D // 32]; the engine
            # slices the doc axis per launch to [ndev, L * Db // 32]
            assert words.size == int(np.prod(self.bitmap_layout)), (words.size, self.bitmap_layout)
            words = words.reshape(self.bitmap_layout)
            self.row_sharded_params.add(key)
        self.params[key] = words
        if not negate and not has_nulls:
            self._plain_bitmaps.add(key)
        self._null_guard(name, has_nulls)
        self.index_uses.append((name, kind))

        def eval_bitmap(cols, params, dev, _key=key, _name=name, _has=has_nulls, _neg=negate):
            t = unpack_bitmap_words(params[_key].reshape(-1), n)
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
                if codes_arr.ndim == 2:
                    # stacked [S, D]: the flat row-major order is the build
                    # order with all padding at the tail; doc ranges are in
                    # global flat coordinates (docs_fn)
                    codes_arr = codes_arr.reshape(-1)[: self.segment.total_docs]
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
        if pt in (PredicateType.REGEXP_LIKE, PredicateType.LIKE, PredicateType.TEXT_MATCH, PredicateType.JSON_MATCH):
            raise ValueError(f"{pt.value} requires a dictionary-encoded column (lhs={p.lhs})")
        null_handling = self.null_handling
        self.used_columns.update(c for c in p.lhs.columns() if c != "*")

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
                vals, nulls = eval_expr(p.lhs, seg, cols, dev)
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
            vals, nulls = eval_expr(p.lhs, seg, cols, dev)
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
