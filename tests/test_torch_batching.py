"""Cross-query batching in the port against the JAX package.

- The fused scan's custom op under torch.func.vmap (its vmap rule) equals
  the per-member loop of the plain version, for shared and stacked keys,
  masks, values, bitmap words and per-member code ranges; the members a
  member-axis launch would take all resolve to one instantiation, each a
  dense slice of the stacked operands (build_params runs on CPU tensors).
- batch_layout finds the operands every member shares and the members a
  block scans together (with a shared key in a specialised instantiation,
  as many as the shared memory holds tables for: 4 of 8 at three entries
  over 2406 groups; else 1: a stacked key, the generic instantiation, the
  global-table path); the vmap rule's ScanBatch (vmap_batch) holds, for
  each member, a full build_params of its own slices field by field, for
  a later chunk of members too, gives every member one row tiling, and
  refuses a mask slot that members would not share alike.
- executor.launch_segment_batch / collect_segment_batch equal the JAX
  package's batched results and the port's sequential results member by
  member (partials compared exactly: integer kinds bit for bit), on the
  plain torch path and on the kernel-backend path (the op's vmap rule);
  member stats sum to one unbatched run; mixed shapes, a batch over
  batch_width() and a closure vmap cannot carry (the sparse group-by's
  in-place scatters) raise BatchShapeError.
- DistributedEngine.execute_many equals the JAX execute_many on eligible
  groups (one batched run each), ineligible ones (config 2's row-sharded
  range-index words, sparse group-bys, several macro-batches) and mixed
  lists, with the same dist.batches / dist.batchFallbacks counts.
- The MicroBatcher unit cases of tests/test_batching.py, on a fake clock.
"""
import ctypes

import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401
from pinot_tpu.ops import pallas_scan  # noqa: F401
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.query import executor as jax_executor
from pinot_tpu.sql.parser import parse_query as jax_parse
from pinot_tpu.utils.metrics import METRICS as JAX_METRICS

from pinot_tpu_torch.cluster.batcher import MicroBatcher
from pinot_tpu_torch.ops import fused_scan
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.query import executor
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.sql.parser import parse_query as port_parse
from pinot_tpu_torch.utils.cache import named_cache_stats
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS

from test_torch_dist_engine import _launch_bytes_for, _stacked_pair
from test_torch_query import SMEM_OPTIN, assert_rows_match, build_engines, make_data
from torch_port_state import port_state  # noqa: F401

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the op's vmap rule
# ---------------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pack16(codes):
    return _t(codes.astype(np.uint32)[0::2] | (codes.astype(np.uint32)[1::2] << 16)).view(torch.int32)


VMAP_CASES = ["stacked_masks", "shared_mask_stacked_words", "per_member_code_range", "stacked_key_and_values",
              "many_entries"]


def _vmap_case(case, rng, W=5, n=1024, G=37):
    codes = rng.integers(0, G + 3, n).astype(np.int32)  # some codes out of the table
    vals = _t(rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32))
    thr = _t(rng.integers(-(1 << 19), 1 << 19, W).astype(np.int32))
    words = _t(rng.integers(0, 1 << 31, (W, n // 32)).astype(np.int32))
    shared_mask = _t(rng.random(n) < 0.8)
    if case == "stacked_masks":
        def f(t, w):
            m = vals < t
            return fused_scan.fused_group_tables(
                [("count", None, m, None), ("int_sum", vals, m, (3, True)), ("count", None, shared_mask, None)],
                None, G, codes_packed=(_pack16(codes), 16))
        return f, (thr, words)
    if case == "shared_mask_stacked_words":
        def f(t, w):
            return fused_scan.fused_group_tables(
                [("count", None, shared_mask, None), ("int_sum", vals, shared_mask, None)],
                _t(codes), G, mask_words=w)
        return f, (thr, words)
    if case == "per_member_code_range":
        pc = _t(rng.integers(0, 11, n).astype(np.int32))

        def f(t, w):
            lo = (t.abs() % 8).to(torch.int64)
            return fused_scan.fused_group_tables(
                [("count", None, shared_mask, None), ("int64_sum", vals.to(torch.int64), shared_mask, 5)],
                _t(codes), G, code_pred=(pc, lo, lo + 3), mask_words=w)
        return f, (thr, words)
    if case == "stacked_key_and_values":
        keys = _t(rng.integers(0, G, (W, n)).astype(np.int16))
        vs = _t(rng.integers(0, 1000, (W, n)).astype(np.uint16))

        def f(k, v):
            return fused_scan.fused_group_tables(
                [("count", None, shared_mask, None), ("int_sum", v, shared_mask, (2, False))], k, G)
        return f, (keys, vs)

    def f(t, w):  # more entries than one launch takes
        ents = [("int_sum", vals + i, vals < t + i, None) for i in range(fused_scan.MAX_ENTRIES + 3)]
        return fused_scan.fused_group_tables(ents, _t(codes), G)
    return f, (thr, words)


@pytest.mark.parametrize("case", VMAP_CASES)
def test_vmap_rule_equals_member_loop(case):
    rng = np.random.default_rng(VMAP_CASES.index(case))
    f, args = _vmap_case(case, rng)
    got = torch.func.vmap(f)(*args)
    W = args[0].shape[0]
    for w in range(W):
        want = f(*(a[w] for a in args))
        assert len(got) == len(want)
        for g, x in zip(got, want):
            assert g.dtype == torch.float64
            assert torch.equal(g[w], x), case


@pytest.mark.parametrize("case", ["stacked_masks", "shared_mask_stacked_words", "per_member_code_range"])
def test_member_launch_params(monkeypatch, case):
    """What the CUDA rule hands the member-axis launch, checked on CPU
    tensors: one instantiation for every member, shared operands at one
    address, stacked ones at a member stride, per-member code ranges."""
    rng = np.random.default_rng(11)
    f, args = _vmap_case(case, rng)
    captured = []

    def capture(info, in_dims, *op_args):
        captured.append(fused_scan.member_args(info.batch_size, in_dims, *op_args))
        return torch.stack([fused_scan._fused_op(*a) for a in captured[-1]]), 0

    fused_scan._fused_op.register_vmap(capture)
    try:
        torch.func.vmap(f)(*args)
    finally:
        fused_scan._fused_op.register_vmap(fused_scan._fused_vmap)
    (members,) = captured
    variants, keys, masks0, los = set(), set(), [], []
    for a in members:
        entries, key_bits, n, num_groups, mask_words, code_pred = fused_scan._scan_args(*a)
        p, order, variant = fused_scan.build_params(entries, a[0], key_bits, n, num_groups, mask_words, code_pred,
                                                    SMEM_OPTIN)
        variants.add(variant)
        keys.add(p.key)
        masks0.append(p.masks[0])
        los.append((p.pred_lo, p.pred_hi))
    assert len(variants) == 1 and len(keys) == 1
    if case == "stacked_masks":
        steps = np.diff(masks0)
        assert len(set(steps)) == 1 and steps[0] == 1024  # bool rows, one member apart
    if case == "per_member_code_range":
        t = args[0]
        assert los == [(int(x) % 8, int(x) % 8 + 3) for x in t.abs()]


# ---------------------------------------------------------------------------
# the member-axis launch's layout and patched parameters
# ---------------------------------------------------------------------------
def _layout_case(case, rng):
    """Four shapes beside VMAP_CASES: three entries over 2406 groups (W = 8,
    more tables than one block holds for all members), members whose
    stacked values start 1025 rows apart, members with their own int16
    predicate codes over a shared int32 key, and the global-table path (4
    sums over 8192 groups)."""
    if case == "three_entries_g2406":
        W, n, G = 8, 2048, 2406
        codes = rng.integers(0, G, n).astype(np.int32)
        rev = _t(rng.integers(100, 1_000_000, n).astype(np.int32))
        qty = _t(rng.integers(1, 51, n).astype(np.int32))
        ks = torch.arange(18, 18 + W, dtype=torch.int32)

        def f(k):
            m = qty < k
            return fused_scan.fused_group_tables(
                [("count", None, m, None), ("int_sum", rev, m, (3, False)), ("int_sum", qty, m, (1, False))],
                None, G, codes_packed=(_pack16(codes), 16))
        return f, (ks,), G
    if case == "odd_member_stride":  # members' int8 values 1025 rows apart: no common aligned head
        W, n, G = 3, 1025, 50
        key = _t(rng.integers(0, G, n).astype(np.int32))
        mask = _t(rng.random(n) < 0.5)

        def f(v):
            return fused_scan.fused_group_tables([("count", None, mask, None), ("int_sum", v, mask, (1, True))],
                                                 key, G)
        return f, (_t(rng.integers(-100, 100, (W, n)).astype(np.int8)),), G
    if case == "stacked_code_ranges":  # each member's own int16 codes, an i32 key shared (the group path)
        W, n, G = 5, 1031, 100
        key = _t(rng.integers(0, G, n).astype(np.int32))
        vals = _t(rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32))
        ones = torch.ones(n, dtype=torch.bool)

        def f(pc, lo):
            return fused_scan.fused_group_tables([("count", None, ones, None), ("int_sum", vals, ones, None)], key,
                                                 G, code_pred=(pc, lo, lo + 6))
        return f, (_t(rng.integers(-5, 20, (W, n)).astype(np.int16)), _t(rng.integers(-5, 10, W).astype(np.int64))), G
    W, n, G = 3, 1024, 8192
    codes = _t(rng.integers(0, G, n).astype(np.int32))
    vals = _t(rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32))
    thr = _t(rng.integers(-(1 << 19), 1 << 19, W).astype(np.int32))

    def f(t):
        m = vals < t
        return fused_scan.fused_group_tables([("int_sum", vals + i, m, None) for i in range(4)], codes, G)
    return f, (thr,), G


LAYOUT_CASES = VMAP_CASES + ["three_entries_g2406", "odd_member_stride", "stacked_code_ranges", "global_table"]
# (key, words, pred, masks, values, group) of each case's first launch
LAYOUTS = {
    "stacked_masks": (True, False, False, (False, True), (False, True, False), 5),
    "shared_mask_stacked_words": (True, False, False, (True,), (False, True), 5),
    "per_member_code_range": (True, False, True, (True,), (False, True), 1),
    "stacked_key_and_values": (False, False, False, (True,), (False, False), 1),
    "many_entries": (True, False, False, (False,) * fused_scan.MAX_ENTRIES, (True,) * fused_scan.MAX_ENTRIES, 5),
    "three_entries_g2406": (True, False, False, (False,), (False, True, True), 4),
    "odd_member_stride": (True, False, False, (True,), (False, False), 1),
    "stacked_code_ranges": (True, False, False, (True,), (False, True), 5),
    "global_table": (True, False, False, (False,), (True,) * 4, 1),
}


def _case(case):
    rng = np.random.default_rng(LAYOUT_CASES.index(case))
    if case in VMAP_CASES:
        f, args = _vmap_case(case, rng)
        return f, args, 37
    return _layout_case(case, rng)


def _capture(case):
    """The op's arguments under vmap for the case: (W, in_dims, op_args, G)."""
    f, args, G = _case(case)
    captured = []

    def capture(info, in_dims, *op_args):
        captured.append((info.batch_size, in_dims, op_args))
        return torch.stack([fused_scan._fused_op(*a) for a in fused_scan.member_args(info.batch_size, in_dims,
                                                                                      *op_args)]), 0

    fused_scan._fused_op.register_vmap(capture)
    try:
        torch.func.vmap(f)(*args)
    finally:
        fused_scan._fused_op.register_vmap(fused_scan._fused_vmap)
    return (*captured[0], G)


def _members_of(W, in_dims, op_args):
    """Each member's own call of the first chunk of entries, from its
    slices: (entries, key, key_bits, n, mask_words, code_pred)."""
    members = []
    for a in fused_scan.member_args(W, in_dims, *op_args):
        entries, key_bits, n, _g, mask_words, code_pred = fused_scan._scan_args(*a)
        members.append((entries[:fused_scan.MAX_ENTRIES], a[0], key_bits, n, mask_words, code_pred))
    return members


def _vmap_batch(W, in_dims, op_args, G, w0=0, members=None):
    """The vmap rule's ScanBatch for members [w0, w0 + members) of the first
    chunk of entries: (batch, order, variant, layout)."""
    key, tensors, spec = op_args
    a = fused_scan._op_parts(tensors, spec)
    ranges = None
    if a.pred is not None:
        td = in_dims[1]
        ranges = list(zip(fused_scan._member_bounds(a.lo, td[a.lo_at], W),
                          fused_scan._member_bounds(a.hi, td[a.lo_at + 1], W)))
    return fused_scan.vmap_batch(fused_scan._stacked(in_dims, *op_args), a.entries[:fused_scan.MAX_ENTRIES], key,
                                 a.key_bits, a.mask_words, a.pred, ranges, w0, W - w0 if members is None else members,
                                 G, SMEM_OPTIN)


def _fields(x, prefix=""):
    """Every scalar field of a ctypes structure, by its dotted path."""
    if isinstance(x, ctypes.Structure):
        for name, _t in x._fields_:
            yield from _fields(getattr(x, name), f"{prefix}{name}.")
    elif isinstance(x, ctypes.Array):
        for i, v in enumerate(x):
            yield from _fields(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], x


def _differ(got, want, skip=()):
    g, w = dict(_fields(got)), dict(_fields(want))
    return [k for k in w if g[k] != w[k] and k not in skip]


@pytest.mark.parametrize("case", ["three_entries_g2406", "odd_member_stride", "stacked_code_ranges", "global_table"])
def test_vmap_rule_layout_cases(case):
    f, args, _G = _case(case)
    got = torch.func.vmap(f)(*args)
    for w in range(args[0].shape[0]):
        for g, x in zip(got, f(*(a[w] for a in args))):
            assert torch.equal(g[w], x), case


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_batch_layout(case):
    W, in_dims, op_args, G = _capture(case)
    b, _order, variant, layout = _vmap_batch(W, in_dims, op_args, G)
    params = [b.m[w] for w in range(W)]
    assert layout == fused_scan.batch_layout(params, SMEM_OPTIN)
    assert tuple(layout) == LAYOUTS[case]
    assert (b.h.members, b.h.group) == (W, layout.group)
    if layout.group > 1:  # the kernel's member path: a shared key, a specialised instantiation
        assert layout.key and variant in ("p16/i32/shared", "i32/i32/shared")
        assert layout.group * 4 * params[0].smem_words <= SMEM_OPTIN
        assert layout.group == W or (layout.group + 1) * 4 * params[0].smem_words > SMEM_OPTIN
    if case == "three_entries_g2406":  # two groups of 4
        assert -(-W // layout.group) == 2


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_vmap_batch_equal_full_build(case):
    """Each member's parameters in the vmap rule's ScanBatch (member 0
    built, the others moved on by their member strides) equal a full
    build_params of that member's own slices, field by field."""
    W, in_dims, op_args, G = _capture(case)
    b, order, variant, _layout = _vmap_batch(W, in_dims, op_args, G)
    # members whose own streams align at different rows share one tiling
    # (test_vmap_batch_one_row_tiling); every other field is the full build's
    tiling = {"head", "tiles"} if case == "odd_member_stride" else set()
    for w, (entries, key, bits, n, words, code_pred) in enumerate(_members_of(W, in_dims, op_args)):
        full, full_order, full_variant = fused_scan.build_params(entries, key, bits, n, G, words, code_pred,
                                                                 SMEM_OPTIN)
        assert (order, variant) == (full_order, full_variant)
        assert _differ(b.m[w], full, tiling) == [], (case, w)
    assert len({(b.m[w].head, b.m[w].tiles) for w in range(W)}) == 1


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_vmap_batch_member_chunk(case):
    """A later chunk of members (w0 = 1, as the rule takes members past
    MAX_MEMBERS) gets the same parameters as those members have in the
    whole batch, and the same shared operands."""
    W, in_dims, op_args, G = _capture(case)
    whole = _vmap_batch(W, in_dims, op_args, G)
    part = _vmap_batch(W, in_dims, op_args, G, w0=1)
    assert part[1:3] == whole[1:3]
    tiling = {"head", "tiles"} if case == "odd_member_stride" else set()
    for w in range(W - 1):
        assert _differ(part[0].m[w], whole[0].m[w + 1], tiling) == [], (case, w)
    assert tuple(part[3])[:-1] == tuple(whole[3])[:-1]
    assert part[0].h.members == W - 1


def test_vmap_batch_one_row_tiling():
    """Members whose own streams align at different rows share the first
    row that suits all (here none: every member reads scalar tiles)."""
    W, in_dims, op_args, G = _capture("odd_member_stride")
    own = [fused_scan.build_params(*m[:4], G, None, None, SMEM_OPTIN)[0] for m in _members_of(W, in_dims, op_args)]
    assert own[0].tiles > 0 and own[1].tiles == 0
    b, _order, _variant, _layout = _vmap_batch(W, in_dims, op_args, G)
    assert {(b.m[w].head, b.m[w].tiles) for w in range(W)} == {(0, 0)}


def test_vmap_batch_refuses_mask_shared_at_member_0_only():
    """A stacked mask whose member-0 slice is also another entry's mask
    would share a slot at member 0 only: refused."""
    rng = np.random.default_rng(6)
    W, n, G = 3, 256, 11
    key = _t(rng.integers(0, G, n).astype(np.int32))
    stacked = _t(rng.random((W, n)) < 0.5)
    entries = [("count", None, stacked, None), ("count", None, stacked[0], None)]
    with pytest.raises(ValueError, match="shares a slot"):
        fused_scan.vmap_batch({id(stacked): stacked}, entries, key, 0, None, None, None, 0, W, G, SMEM_OPTIN)


# ---------------------------------------------------------------------------
# launch_segment_batch / collect_segment_batch
# ---------------------------------------------------------------------------
SEG_BATCHED = [
    "SELECT city, SUM(v), COUNT(*) FROM t WHERE year < {y} GROUP BY city LIMIT 100",
    "SELECT city, MIN(v), MAX(price), AVG(v) FROM t WHERE day < {d2} GROUP BY city LIMIT 100",
    "SELECT COUNT(*), SUM(v), SUM(big) FROM t WHERE day BETWEEN {d} AND {d2}",
    "SELECT year, day, COUNT(*) FROM t WHERE v > {v} GROUP BY year, day LIMIT 100000",
    "SELECT city, tag, SUM(v) FROM t WHERE year < {y} AND day < {d2} GROUP BY city, tag LIMIT 100",
]


def _members(sql, k):
    return [sql.format(y=2003 + 3 * i, d=10 * i, d2=100 + 20 * i, v=100 * i) for i in range(k)]


@pytest.fixture(scope="module")
def segs():
    """(JAX segment, port segment): one indexed segment of 2048 rows built
    by each package from the same data."""
    jx, port = build_engines({"t": (True, [make_data(21, 2048)])})
    return jx.table("t").query_segments()[0], port.table("t").query_segments()[0]


def _same_partials(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_partials(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_partials(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (x, y)


def _same_result(a, b):
    assert type(a).__name__ == type(b).__name__
    if hasattr(a, "keys") and a.keys is not None:
        _same_partials(list(a.keys), list(b.keys))
    _same_partials(a.partials, b.partials)


@pytest.mark.parametrize("kernel_path", [False, True], ids=["torch_path", "kernel_op_path"])
@pytest.mark.parametrize("sql", SEG_BATCHED)
def test_segment_batch_matches_jax_and_sequential(monkeypatch, segs, sql, kernel_path):
    jseg, pseg = segs
    if kernel_path:
        monkeypatch.setattr(port_planner, "backend_tag", lambda device: "cuda")
    qs = _members(sql, 5)
    got = executor.collect_segment_batch(executor.launch_segment_batch([port_parse(q) for q in qs], pseg, CPU))
    want = jax_executor.collect_segment_batch(jax_executor.launch_segment_batch([jax_parse(q) for q in qs], jseg))
    for q, (res, st), (jres, jst) in zip(qs, got, want):
        seq, _ = executor.collect_segment(executor.launch_segment(port_parse(q), pseg, CPU))
        _same_result(res, seq)
        _same_result(res, jres)
        assert st.num_docs_scanned == jst.num_docs_scanned
    one = executor.collect_segment(executor.launch_segment(port_parse(qs[0]), pseg, CPU))[1]
    assert sum(st.num_docs_scanned for _r, st in got) == one.num_docs_scanned
    assert sum(st.kernel_bytes for _r, st in got) == pytest.approx(one.kernel_bytes, rel=1e-9)
    assert sum(st.kernel_flops for _r, st in got) == pytest.approx(one.kernel_flops, rel=1e-9)
    docs = [st.num_docs_scanned for _r, st in got]
    assert max(docs) - min(docs) <= 1
    assert all(st.total_docs == pseg.num_docs for _r, st in got)


def test_batch_closure_built_once(segs):
    _jseg, pseg = segs
    qs = _members(SEG_BATCHED[0], 4)
    executor._batch_fn_cache().clear()
    for _ in range(3):
        executor.collect_segment_batch(executor.launch_segment_batch([port_parse(q) for q in qs], pseg, CPU))
    assert executor.BATCH_AUDIT.snapshot() == {"compiles": 1, "hits": 2}
    assert "compile.batch" in named_cache_stats()


def test_batch_refusals(monkeypatch, segs):
    _jseg, pseg = segs
    mixed = [port_parse("SELECT COUNT(*) FROM t WHERE year < 2005"),
             port_parse("SELECT SUM(v) FROM t WHERE year < 2005")]
    with pytest.raises(executor.BatchShapeError, match="different planned closures"):
        executor.launch_segment_batch(mixed, pseg, CPU)
    monkeypatch.setenv("PINOT_TPU_BATCH_MAX", "3")
    with pytest.raises(executor.BatchShapeError, match="exceeds lane width 3"):
        executor.launch_segment_batch([port_parse(q) for q in _members(SEG_BATCHED[0], 4)], pseg, CPU)
    sparse = [port_parse(f"SET maxDenseGroups = 2; SELECT city, SUM(v) FROM t WHERE year < {2003 + i} "
                         "GROUP BY city") for i in range(3)]
    with pytest.raises(executor.BatchShapeError, match="torch.func.vmap"):
        executor.launch_segment_batch(sparse, pseg, CPU)
    with pytest.raises(ValueError):
        executor.launch_segment_batch([], pseg, CPU)


def test_batch_selection_members(segs):
    _jseg, pseg = segs
    qs = [f"SELECT city, day FROM t WHERE day < {30 + 40 * i} ORDER BY day LIMIT 7" for i in range(3)]
    got = executor.collect_segment_batch(executor.launch_segment_batch([port_parse(q) for q in qs], pseg, CPU))
    for q, (res, _st) in zip(qs, got):
        seq, _ = executor.collect_segment(executor.launch_segment(port_parse(q), pseg, CPU))
        assert res.columns == seq.columns
        for c in res.columns:
            assert list(res.arrays[c]) == list(seq.arrays[c])


# ---------------------------------------------------------------------------
# DistributedEngine.execute_many
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dist_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
        from pinot_tpu import ops as jax_ops

        jax_ops.scan_backend.cache_clear()
        js, ps = _stacked_pair()
        je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1))
        pe = PortDist(device="cpu")
        je.register_table("t", js)
        pe.register_table("t", ps)
        many = _launch_bytes_for(ps, 3)
        je3 = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=many)
        pe3 = PortDist(device="cpu", launch_bytes=many)
        je3.register_table("t", js)
        pe3.register_table("t", ps)
        yield {"one": (je, pe), "three": (je3, pe3)}
    jax_ops.scan_backend.cache_clear()


def _counter(metrics, name):
    return metrics.snapshot()["counters"].get(name, 0)


MANY = {
    "dense_code_range": [f"SELECT d, COUNT(*), SUM(rev) FROM t WHERE yr BETWEEN {2000 + k} AND {2002 + k} "
                         "GROUP BY d LIMIT 2500" for k in range(8)],
    "aggregation": [f"SELECT COUNT(*), SUM(rev), SUM(disc) FROM t WHERE yr > {2000 + 2 * k}" for k in range(5)],
    "config2_range_index": [f"SELECT d, SUM(rev), COUNT(*) FROM t WHERE q < {18 + k} GROUP BY d LIMIT 2500"
                            for k in range(8)],
    "sparse": [f"SET maxDenseGroups = 2; SELECT disc, SUM(rev) FROM t WHERE yr > {2000 + k} GROUP BY disc "
               "ORDER BY disc LIMIT 20" for k in range(3)],
    "min_max": [f"SELECT city, MIN(rev), MAX(rev) FROM t WHERE yr > {2001 + k} GROUP BY city LIMIT 10"
                for k in range(3)],
    "mixed": ["SELECT COUNT(*) FROM t WHERE yr > 2003", "SELECT d, SUM(rev) FROM t WHERE q < 20 GROUP BY d LIMIT 9",
              "SELECT COUNT(*) FROM t WHERE yr > 2010", "SELECT SUM(rev) FROM t",
              "SELECT d, SUM(rev) FROM t WHERE q < 30 GROUP BY d LIMIT 9"],
}


@pytest.mark.parametrize("engines", ["one", "three"])
@pytest.mark.parametrize("group", list(MANY))
def test_execute_many_matches_jax(dist_pair, group, engines):
    je, pe = dist_pair[engines]
    qs = MANY[group]
    jb, jf = _counter(JAX_METRICS, "dist.batches"), _counter(JAX_METRICS, "dist.batchFallbacks")
    want = je.execute_many([jax_parse(q) for q in qs])
    got = pe.execute_many([port_parse(q) for q in qs])
    for q, g, w in zip(qs, got, want):
        assert_rows_match(g.rows, w.rows, ordered="ORDER BY" in q)
        assert_rows_match(g.rows, pe.query(q).rows, ordered="ORDER BY" in q)
        assert g.stats.total_docs == w.stats.total_docs
    assert sum(g.stats.num_docs_scanned for g in got) == sum(w.stats.num_docs_scanned for w in want)
    assert _counter(PORT_METRICS, "dist.batches") == _counter(JAX_METRICS, "dist.batches") - jb
    assert _counter(PORT_METRICS, "dist.batchFallbacks") == _counter(JAX_METRICS, "dist.batchFallbacks") - jf
    batched = _counter(PORT_METRICS, "dist.batches")
    if engines == "one" and group in ("dense_code_range", "aggregation", "mixed"):
        assert batched >= 1
    if group in ("config2_range_index", "sparse") or engines == "three":
        assert batched == 0


def test_execute_many_one_kernel_op_call_a_group(monkeypatch, dist_pair):
    """On the kernel backend the eligible group reaches the fused scan once,
    with the member axis (the op's vmap rule), and its results are exact."""
    je, pe = dist_pair["one"]
    qs = MANY["dense_code_range"]
    calls = []
    real = fused_scan._fused_vmap

    def rule(info, in_dims, *args):
        calls.append(info.batch_size)
        return real(info, in_dims, *args)

    fused_scan._fused_op.register_vmap(rule)
    monkeypatch.setattr(port_planner, "backend_tag", lambda device: "cuda")
    fresh = PortDist(device="cpu")
    fresh.register_table("t", pe.tables["t"])
    try:
        got = fresh.execute_many([port_parse(q) for q in qs])
    finally:
        fused_scan._fused_op.register_vmap(real)
    assert calls == [len(qs)]
    for q, g in zip(qs, got):
        assert_rows_match(g.rows, je.execute(jax_parse(q)).rows)


def test_execute_many_routes_what_execute_refuses(dist_pair):
    _je, pe = dist_pair["one"]
    with pytest.raises(KeyError):
        pe.execute_many([port_parse("SELECT COUNT(*) FROM nosuch")])
    with pytest.raises(NotImplementedError):
        pe.execute_many([port_parse("SELECT COUNT(*) FROM t UNION SELECT COUNT(*) FROM t")])


# ---------------------------------------------------------------------------
# MicroBatcher (tests/test_batching.py, fake clock)
# ---------------------------------------------------------------------------
def _runner(log, value=lambda i, e: e.payload):
    def run(entries):
        log.append(len(entries))
        for i, e in enumerate(entries):
            e.future.set_result(value(i, e))
    return run


def test_bounded_wait_expiry_flushes_singleton():
    ran = []
    mb = MicroBatcher(_runner(ran), wait_ms=5, max_batch=8, clock=lambda: 0.0)
    fut = mb.submit("k", "q0")
    assert mb.pump(now=0.004) == 0
    assert not fut.done()
    assert mb.pump(now=0.0051) == 1
    assert fut.result() == "q0" and ran == [1]


def test_full_group_flushes_inline_without_clock():
    ran = []
    mb = MicroBatcher(_runner(ran, lambda i, e: i), wait_ms=5, max_batch=3, clock=lambda: 0.0)
    futs = [mb.submit("k", f"q{i}") for i in range(3)]
    assert ran == [3]
    assert [f.result() for f in futs] == [0, 1, 2]
    assert mb.pending() == 0


def test_keys_never_mix():
    groups = []

    def run(entries):
        groups.append([e.payload for e in entries])
        for e in entries:
            e.future.set_result(None)

    mb = MicroBatcher(run, wait_ms=5, max_batch=8, clock=lambda: 0.0)
    mb.submit("a", "a0"), mb.submit("b", "b0"), mb.submit("a", "a1")
    assert mb.flush() == 2
    assert sorted(map(sorted, groups)) == [["a0", "a1"], ["b0"]]


def test_wait_zero_bypasses_coalescing():
    ran = []
    mb = MicroBatcher(_runner(ran), wait_ms=0, max_batch=8, clock=lambda: 0.0)
    mb.submit("k", "q0"), mb.submit("k", "q1")
    assert ran == [1, 1]


def test_runner_crash_fails_futures_not_process():
    def boom(entries):
        raise RuntimeError("runner died")

    mb = MicroBatcher(boom, wait_ms=5, max_batch=8, clock=lambda: 0.0)
    fut = mb.submit("k", "q0")
    mb.flush()
    with pytest.raises(RuntimeError, match="runner died"):
        fut.result()


def test_batcher_wait_reads_the_knob():
    from pinot_tpu_torch.cluster import autopilot

    ran = []
    mb = MicroBatcher(_runner(ran), max_batch=8, clock=lambda: 0.0)
    autopilot.knobs().set("batch_wait_ms", 0)
    mb.submit("k", "q0")
    assert ran == [1]
