"""The port's fused-scan module against the JAX package's Pallas kernel.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against the plain version there).  Here the plain PyTorch version — what
the wrapper takes for CPU tensors — must equal, BIT FOR BIT, both
pallas_scan.fused_group_tables_pallas(interpret=True) and the JAX package's
XLA path on the grid of tests/test_pallas_scan.py: every integer kind
(int8 negatives, full-range int32, int64 with |v| < 2^39 so sums stay in the
f64-exact window), word-mask + code-predicate fusion, packed keys at 4/8/16
bits, the uint32 default-plan read, the alignment error and the eligibility
gates.  Tolerance: exact equality (assert_array_equal).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.ops import pallas_scan, segmented as jax_segmented

from pinot_tpu_torch import device as port_device
from pinot_tpu_torch.ops import fused_scan, segmented


def _entries(rng, n):
    """(kind, values, mask, limb_plan) in numpy: one entry per kind."""
    m = lambda: rng.random(n) < 0.8  # noqa: E731
    return [
        ("count", np.zeros(n, np.int32), m(), None),
        ("int_sum", rng.integers(-120, 120, n).astype(np.int8), m(), (1, True)),
        ("int_sum", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), m(), (4, True)),
        ("int64_sum", rng.integers(-(2**39), 2**39, n).astype(np.int64), m(), None),
    ]


def _jax(entries):
    return [(k, jnp.asarray(v), jnp.asarray(m), lp) for k, v, m, lp in entries]


def _torch(entries):
    return [(k, torch.from_numpy(v), torch.from_numpy(m), lp) for k, v, m, lp in entries]


def _pack(codes, bits):
    f = 32 // bits
    lanes = codes.astype(np.uint32).reshape(-1, f) << (np.arange(f, dtype=np.uint32) * np.uint32(bits))
    return np.bitwise_or.reduce(lanes, axis=1).astype(np.uint32)


def _assert_tables_equal(got, *refs):
    for ref in refs:
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == torch.float64
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n", [32, 4096, 4096 * 2 + 32, 1000])  # 1000: ragged tail
@pytest.mark.parametrize("num_groups", [1, 7, 300])
def test_plain_matches_pallas_and_xla(rng, n, num_groups):
    entries = _entries(rng, n)
    codes = rng.integers(0, num_groups, n).astype(np.int32)
    got = fused_scan.fused_group_tables(_torch(entries), torch.from_numpy(codes), num_groups)
    pallas = pallas_scan.fused_group_tables_pallas(
        _jax(entries), jnp.asarray(codes), num_groups, interpret=True
    )
    xla = jax_segmented.fused_group_tables(_jax(entries), jnp.asarray(codes), num_groups, backend="xla")
    _assert_tables_equal(got, pallas, xla)


def test_word_mask_and_code_pred_fusion(rng):
    n = 4096 + 64
    entries = _entries(rng, n)
    codes = rng.integers(0, 50, n).astype(np.int32)
    words = np.packbits((rng.random(n) < 0.5).reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).reshape(-1)
    lo, hi = 10, 40
    got = fused_scan.fused_group_tables(
        _torch(entries), torch.from_numpy(codes), 50,
        mask_words=torch.from_numpy(words.view(np.int32)),
        code_pred=(torch.from_numpy(codes), lo, hi),
    )
    want = pallas_scan.fused_group_tables_pallas(
        _jax(entries), jnp.asarray(codes), 50,
        mask_words=jnp.asarray(words), code_pred=(jnp.asarray(codes), lo, hi), interpret=True,
    )
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_packed_key(rng, bits):
    n = 4096 + 32
    num_groups = min(1 << bits, 300)
    entries = _entries(rng, n)
    codes = rng.integers(0, num_groups, n).astype(np.int32)
    words = _pack(codes, bits)
    got = fused_scan.fused_group_tables(
        _torch(entries), None, num_groups, codes_packed=(torch.from_numpy(words.view(np.int32)), bits)
    )
    want = pallas_scan.fused_group_tables_pallas(
        _jax(entries), jnp.asarray(codes), num_groups,
        codes_packed=(jnp.asarray(words), bits), interpret=True,
    )
    _assert_tables_equal(got, want)


def test_uint32_int_sum_reads_as_int32(rng):
    """The Pallas kernel casts int_sum values to int32 under the default
    plan (4, True), so uint32 values >= 2^31 read as negatives; the port
    reads them the same way."""
    n = 1000
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(n) < 0.8
    codes = rng.integers(0, 7, n).astype(np.int32)
    entries = [("int_sum", vals, mask, None)]
    got = fused_scan.fused_group_tables(_torch(entries), torch.from_numpy(codes), 7)
    want = pallas_scan.fused_group_tables_pallas(_jax(entries), jnp.asarray(codes), 7, interpret=True)
    _assert_tables_equal(got, want)
    as_int32 = np.zeros(7)
    np.add.at(as_int32, codes[mask], vals.view(np.int32)[mask].astype(np.float64))
    np.testing.assert_array_equal(got[0].numpy(), as_int32)


def test_word_mask_requires_alignment():
    n = 40  # not a multiple of 32
    entries = [("count", None, torch.ones(n, dtype=torch.bool), None)]
    with pytest.raises(ValueError):
        fused_scan.fused_group_tables(
            entries, torch.zeros(n, dtype=torch.int32), 4, mask_words=torch.zeros(2, dtype=torch.int32)
        )
    with pytest.raises(ValueError):
        pallas_scan.fused_group_tables_pallas(
            [("count", jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool), None)],
            jnp.zeros((n,), jnp.int32), 4, mask_words=jnp.zeros((2,), jnp.uint32), interpret=True,
        )


@pytest.mark.parametrize(
    "case,num_groups",
    [
        ("count", 16),
        ("count+f32", 16),
        ("count", 0),
        ("count", 8192),
        ("count", 8193),
        ("int64_in_int_sum", 16),
        ("int32_in_int64_sum", 16),
        ("uint16_int_sum", 16),
    ],
)
def test_kernel_supported_gates_match_pallas(case, num_groups):
    n = 64
    count = ("count", np.zeros(n, np.int32), np.ones(n, bool), None)
    entries = {
        "count": [count],
        "count+f32": [count, ("f32_sum", np.zeros(n, np.float32), np.ones(n, bool), None)],
        "int64_in_int_sum": [("int_sum", np.zeros(n, np.int64), np.ones(n, bool), None)],
        "int32_in_int64_sum": [("int64_sum", np.zeros(n, np.int32), np.ones(n, bool), None)],
        "uint16_int_sum": [("int_sum", np.zeros(n, np.uint16), np.ones(n, bool), None)],
    }[case]
    assert fused_scan.kernel_supported(_torch(entries), num_groups) == pallas_scan.pallas_supported(
        _jax(entries), num_groups
    )


def test_segmented_dispatch_on_cpu_takes_plain_path(rng):
    """backend="cuda" routes eligible entry sets to the fused-scan wrapper;
    on CPU tensors the wrapper computes the plain version and launches
    nothing.  The torch path ("torch" backend, float kinds) agrees."""
    n = 4096
    entries = _torch(_entries(rng, n))
    codes = torch.from_numpy(rng.integers(0, 300, n).astype(np.int32))
    before = fused_scan.LAUNCHES
    via_kernel_route = segmented.fused_group_tables(entries, codes, 300, backend="cuda")
    via_torch = segmented.fused_group_tables(entries, codes, 300, backend="torch")
    assert fused_scan.LAUNCHES == before
    for a, b in zip(via_kernel_route, via_torch):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    words = torch.from_numpy(_pack(codes.numpy(), 16).view(np.int32))
    packed = segmented.fused_group_tables(entries, None, 300, backend="torch", codes_packed=(words, 16))
    for a, b in zip(packed, via_torch):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_takes_plain_version_only_on_cpu():
    """A tensor on neither the CPU nor CUDA raises; it is never handed to
    the plain version."""
    n = 64
    entries = [("count", None, torch.ones(n, dtype=torch.bool, device="meta"), None)]
    before = fused_scan.LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_scan.fused_group_tables(entries, torch.zeros(n, dtype=torch.int32, device="meta"), 4)
    assert fused_scan.LAUNCHES == before


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# Host-side launch planning of the CUDA kernel (no card needed): mask dedup,
# the choice of instantiation, alignment of operand views, the ScanParams
# layout.  The kernel itself is held against the plain version on the card.
# ---------------------------------------------------------------------------
SMEM_OPTIN = 232448  # an H100's dynamic shared-memory opt-in per block


def _views(n, dtype, offset):
    """A contiguous [n] view starting `offset` elements into a larger buffer."""
    return torch.zeros(n + offset, dtype=dtype)[offset:]


@pytest.mark.parametrize(
    "layout,want_distinct,want_idx",
    [
        ("one", 1, [0]),
        ("same tensor twice", 1, [0, 0]),
        ("same storage, another view object", 1, [0, 0]),
        ("two distinct", 2, [0, 1]),
        ("a, b, a, b", 2, [0, 1, 0, 1]),
        ("same buffer, other offset", 2, [0, 1]),
    ],
)
def test_dedup_masks(layout, want_distinct, want_idx):
    buf = torch.ones(80, dtype=torch.bool)
    a, b = buf[:64], torch.ones(64, dtype=torch.bool)
    masks = {
        "one": [a],
        "same tensor twice": [a, a],
        "same storage, another view object": [a, buf[:64]],
        "two distinct": [a, b],
        "a, b, a, b": [a, b, a, b],
        "same buffer, other offset": [a, buf[16:80]],
    }[layout]
    distinct, idx = fused_scan.dedup_masks(masks)
    assert len(distinct) == want_distinct and idx == want_idx
    for m, i in zip(masks, idx):
        assert distinct[i].data_ptr() == m.data_ptr()


@pytest.mark.parametrize(
    "dtype,bits,want",
    [
        (torch.int32, 0, "i32"), (torch.int64, 0, "any"), (torch.int8, 0, "any"), (torch.uint32, 0, "any"),
        (torch.int32, 4, "any"), (torch.int32, 8, "any"), (torch.int32, 16, "p16"), (torch.int32, 2, "any"),
    ],
)
def test_key_mode(dtype, bits, want):
    assert fused_scan.key_mode(dtype, bits) == want


@pytest.mark.parametrize(
    "kinds,want",
    [
        ((), "i32"),
        (("count",), "i32"),
        (("count", "int_sum:int32"), "i32"),
        (("int_sum:uint32", "int_sum:int32"), "i32"),
        (("count", "int64_sum:int64"), "any"),
        (("int64_sum:int64", "int64_sum:int64"), "any"),
        (("count", "int_sum:int8"), "any"),
        (("int_sum:int16", "int_sum:int32"), "any"),
        (("int_sum:uint16",), "any"),
        (("int_sum:int32", "int64_sum:int64"), "any"),
    ],
)
def test_value_mode(kinds, want):
    assert fused_scan.value_mode(_entries_of(kinds)) == want


def _entries_of(kinds, n=64):
    entries = []
    for k in kinds:
        kind, _, dt = k.partition(":")
        values = torch.zeros(n, dtype=getattr(torch, dt)) if dt else None
        entries.append((kind, values, torch.ones(n, dtype=torch.bool), None))
    return entries


@pytest.mark.parametrize(
    "key_dtype,bits,kinds,shared,want",
    [
        (torch.int32, 16, ("count", "int_sum:int32"), True, ("p16", "i32")),  # query (a)
        (torch.int32, 0, ("count", "int_sum:int32"), True, ("i32", "i32")),  # query (c)
        (torch.int32, 0, ("count",), True, ("i32", "i32")),
        (torch.int32, 16, ("count", "int_sum:int8"), True, ("any", "any")),
        (torch.int32, 8, ("count", "int_sum:int32"), True, ("any", "any")),
        (torch.int64, 0, ("count", "int_sum:int32"), True, ("any", "any")),
        (torch.int32, 0, ("int64_sum:int64",), True, ("any", "any")),
        (torch.int32, 0, ("count", "int_sum:int32"), False, ("any", "any")),  # global path: generic only
        (torch.int32, 16, ("count",), False, ("any", "any")),
    ],
)
def test_instantiation(key_dtype, bits, kinds, shared, want):
    """A specialised pair only where the shape is one; every instantiation
    the wrapper can pick is one the kernel library has."""
    got = fused_scan.instantiation(key_dtype, bits, _entries_of(kinds), shared)
    assert got == want
    assert f"{got[0]}/{got[1]}/{'shared' if shared else 'global'}" in fused_scan.INSTANTIATIONS


@pytest.mark.parametrize(
    "streams,want",
    [
        ([(0, 32, False), (0, 8, False)], 0),
        ([(4, 32, False), (1, 8, False)], 3),  # int32 one element in, mask one byte in
        ([(8, 64, False), (1, 8, False)], 3),  # int64 one element in: any odd row
        ([(0, 32, False), (1, 8, False)], None),  # int32 aligned, mask one byte in
        ([(0, 16, True), (1, 8, False)], None),  # packed lanes need an even row
        ([(0, 16, True), (2, 8, False)], None),  # the mask wants rows 2, 6, ...: word pairs at 4 mod 8
        ([(4, 16, True), (2, 8, False)], 2),  # words one word in: row 2 starts a word pair on 8 bytes
        ([(0, 8, True), (2, 8, False)], None),  # 8-bit lanes start quads on a word: rows 0, 4, ...
        ([(2, 4, True)], 0),  # 4-bit lanes: a quad is a half word
        ([(0, 4, True), (3, 8, False)], None),  # quads of 4-bit lanes start on rows 0, 4, ...
        ([(0, 1, True)], 0),
        ([(1, 16, False)], None),  # int16 one byte in: never aligned
    ],
)
def test_tile_head(streams, want):
    assert fused_scan.tile_head(streams) == want


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3), (1, 2, 3), (2, 1, 0), (0, 3, 0)])
def test_build_params_aligns_views(offsets):
    """Views at element offsets 0-3: the head is the first row where every
    operand is aligned for the vector loads, the tiles cover whole 512-row
    warp tiles after it, and operands with no common head get no vector
    tiles (every row takes the scalar loads)."""
    n = 512 * 3 + 37
    ko, mo, vo = offsets
    key = _views(n, torch.int32, ko)
    mask = _views(n, torch.bool, mo)
    vals = _views(n, torch.int32, vo)
    entries = [("count", None, mask, None), ("int_sum", vals, mask, (4, True))]
    p, order, variant = fused_scan.build_params(entries, key, 0, n, 300, None, None, SMEM_OPTIN)
    assert variant == "i32/i32/shared" and order == [0, 1]
    head = fused_scan.tile_head([(key.data_ptr(), 32, False), (vals.data_ptr(), 32, False), (mask.data_ptr(), 8, False)])
    if head is None:
        assert (p.head, p.tiles) == (0, 0)
    else:
        assert p.head == head and p.tiles == (n - head) // fused_scan.WARP_TILE_ROWS
        for t, size in ((key, 4), (vals, 4)):
            assert (t.data_ptr() + head * size) % 16 == 0
        assert (mask.data_ptr() + head) % 4 == 0
    same_misalignment = ko == vo and (mo - ko) % 4 == 0
    assert (head is not None) == same_misalignment


def test_build_params_main_path_shape():
    """The main path: packed 16-bit key, one mask shared by COUNT(*) and
    SUM(int32), 2406 groups -> one mask read, the specialised instantiation,
    a count table of 32-bit counters and a lo/hi table for the sum."""
    n, g = 4096, 2406
    words = torch.zeros(n // 2, dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool)
    rev = torch.zeros(n, dtype=torch.int32)
    entries = [("count", None, mask, None), ("int_sum", rev, mask, (3, False))]
    p, order, variant = fused_scan.build_params(entries, words, 16, n, g, None, None, SMEM_OPTIN)
    assert variant == "p16/i32/shared"
    assert (p.num_entries, p.num_masks, p.key_bits, p.n) == (2, 1, 16, n)
    assert p.masks[0] == mask.data_ptr() and not p.masks[1]
    assert [p.e[j].mask_idx for j in range(2)] == [0, 0]
    assert [p.e[j].smem_off for j in range(2)] == [0, g]
    assert p.smem_words == 3 * g and p.shared == 1
    assert (p.head, p.tiles) == (0, n // fused_scan.WARP_TILE_ROWS)
    assert (p.e[1].kind, p.e[1].vtype, p.e[1].n_limbs, p.e[1].is_signed) == (1, 4, 3, 0)
    assert fused_scan.KEY_MODES[p.key_mode] == "p16" and fused_scan.VALUE_MODES[p.val_mode] == "i32"


@pytest.mark.parametrize(
    "mask_of,want_order,want_idx",
    [
        ("aab", [0, 1, 2], [0, 0, 1]),
        ("aba", [0, 2, 1], [0, 0, 1]),
        ("bab", [0, 2, 1], [0, 0, 1]),
        ("abc", [0, 1, 2], [0, 1, 2]),
        ("cbab", [0, 1, 3, 2], [0, 1, 1, 2]),
    ],
)
def test_build_params_sorts_entries_by_mask(mask_of, want_order, want_idx):
    """Entries reach the kernel grouped by their mask's index (a stable sort),
    each table row j belongs to entries[order[j]], and the shared tables are
    laid out in that order."""
    n = 640
    masks = {c: torch.ones(n, dtype=torch.bool) for c in "abc"}
    entries = [("int_sum" if i % 2 else "count", torch.zeros(n, dtype=torch.int32) if i % 2 else None, masks[c], None)
               for i, c in enumerate(mask_of)]
    p, order, _ = fused_scan.build_params(entries, torch.zeros(n, dtype=torch.int32), 0, n, 10, None, None, SMEM_OPTIN)
    assert order == want_order
    assert [p.e[j].mask_idx for j in range(len(entries))] == want_idx
    offs, words = fused_scan.table_layout([entries[i] for i in order], 10)
    assert [p.e[j].smem_off for j in range(len(entries))] == offs and p.smem_words == words
    for j, i in enumerate(order):
        assert p.masks[p.e[j].mask_idx] == entries[i][2].data_ptr()


@pytest.mark.parametrize(
    "kinds,num_groups,want_variant",
    [
        (("count", "i32"), 2406, "i32/i32/shared"),  # 28.9 KB of tables
        (("count", "i8", "i32"), 8192, "any/any/shared"),  # 160 KB
        (("count", "i8", "i32", "i64"), 8192, "any/any/shared"),  # 224 KB: still fits
        (("i8", "i32", "i64", "i16"), 8192, "any/any/global"),  # 256 KB: the global-atomic path
        (("count",) * 7, 8192, "i32/i32/shared"),  # 7 count tables of 32-bit counters: 224 KB
        (("count",) * 16, 8192, "any/any/global"),  # 512 KB
    ],
)
def test_build_params_path(kinds, num_groups, want_variant):
    n = 1024
    make = {
        "count": lambda: ("count", None),
        "i8": lambda: ("int_sum", torch.zeros(n, dtype=torch.int8)),
        "i16": lambda: ("int_sum", torch.zeros(n, dtype=torch.int16)),
        "i32": lambda: ("int_sum", torch.zeros(n, dtype=torch.int32)),
        "i64": lambda: ("int64_sum", torch.zeros(n, dtype=torch.int64)),
    }
    mask = torch.ones(n, dtype=torch.bool)
    entries = [(*make[k](), mask, None) for k in kinds]
    p, _order, variant = fused_scan.build_params(
        entries, torch.zeros(n, dtype=torch.int32), 0, n, num_groups, None, None, SMEM_OPTIN)
    _offs, words = fused_scan.table_layout(entries, num_groups)
    assert variant == want_variant
    assert p.shared == (4 * words <= SMEM_OPTIN)
    assert p.smem_words == (words if p.shared else 0)


def test_scan_params_ctypes_layout():
    """The ctypes mirror has the C struct's layout on an LP64 host: three
    pointers, 16 mask pointers, three int64, twelve int32, then 16 entries
    of one pointer and six int32.  The library checks the total size at
    load; the offsets are checked here without it."""
    import ctypes

    P, E = fused_scan._ScanParams, fused_scan._ScanEntry
    assert ctypes.sizeof(E) == 32
    assert (E.values.offset, E.kind.offset, E.mask_idx.offset, E.smem_off.offset) == (0, 8, 24, 28)
    assert (P.masks.offset, P.n.offset, P.head.offset, P.tiles.offset, P.key_type.offset) == (24, 152, 160, 168, 176)
    assert (P.smem_words.offset, P.e.offset) == (220, 224)
    assert ctypes.sizeof(P) == 224 + 16 * 32


def test_build_params_rejects_like_the_kernel_wrapper():
    n = 64
    mask = torch.ones(n, dtype=torch.bool)
    key = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="mask must be bool"):
        fused_scan.build_params([("count", None, mask.to(torch.uint8), None)], key, 0, n, 4, None, None, SMEM_OPTIN)
    with pytest.raises(ValueError, match="contiguous"):
        fused_scan.build_params([("count", None, torch.ones(2 * n, dtype=torch.bool)[::2], None)], key, 0, n, 4,
                                None, None, SMEM_OPTIN)
    with pytest.raises(ValueError, match="shape"):
        fused_scan.build_params([("count", None, mask, None)], key[:-1], 0, n, 4, None, None, SMEM_OPTIN)


def test_launch_counters_lose_no_increment_across_threads():
    """Launches come from several threads (a broker's hedge and batcher
    threads, concurrent scatters): count_launch's read-modify-writes hold a
    lock, so 8 threads x 2,000 launches count exactly, with the interpreter
    switching threads as often as it can."""
    import sys
    import threading

    saved = (fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES), fused_scan.MASK_WORDS_LAUNCHES,
             dict(fused_scan.BATCH_LAUNCHES), fused_scan.BATCH_MEMBERS, dict(fused_scan.BATCH_LAYOUTS))
    fused_scan.reset_counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(2000):
                if i % 2:
                    fused_scan.count_launch("p16/i32/shared", True, members=8, group=8)
                else:
                    fused_scan.count_launch("i32/i32/shared", False)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert fused_scan.LAUNCHES == 16000 and fused_scan.MASK_WORDS_LAUNCHES == 8000
        assert fused_scan.VARIANT_LAUNCHES == {"p16/i32/shared": 8000, "i32/i32/shared": 8000}
        assert fused_scan.BATCH_LAUNCHES == {"p16/i32/shared": 8000} and fused_scan.BATCH_MEMBERS == 64000
        assert fused_scan.BATCH_LAYOUTS == {"8/8": 8000}
    finally:
        sys.setswitchinterval(interval)
        fused_scan.reset_counters()
        fused_scan.LAUNCHES, fused_scan.MASK_WORDS_LAUNCHES, fused_scan.BATCH_MEMBERS = saved[0], saved[2], saved[4]
        fused_scan.VARIANT_LAUNCHES.update(saved[1])
        fused_scan.BATCH_LAUNCHES.update(saved[3])
        fused_scan.BATCH_LAYOUTS.update(saved[5])
