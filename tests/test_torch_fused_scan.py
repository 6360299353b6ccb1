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
