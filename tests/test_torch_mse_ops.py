"""The port's join and exchange primitives against the JAX package's.

lookup_join and range_join (stable sort, searchsorted, the end-clip guard)
on the same seeded keys; hash_dest bit for bit at ndev 1, 3 and 8 over keys
with the top bit set; hash_repartition at ndev = 1 against the JAX function
inside a one-device shard_map, with a capacity below the row count (the
same received rows, validity and overflow); and StackedTable.aliased_view's
shared storage.  All results are integers and must be identical.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from pinot_tpu.mse import exchange as jax_ex
from pinot_tpu.mse import join as jax_join
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import shard_map_compat

from pinot_tpu_torch.mse import exchange as port_ex
from pinot_tpu_torch.mse import join as port_join
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.spi import schema as port_schema


def _keys(seed, n_build, n_probe, key_range, invalid_share=0.2):
    rng = np.random.default_rng(seed)
    build = rng.integers(0, key_range, n_build).astype(np.int64)
    valid = rng.random(n_build) >= invalid_share
    probe = rng.integers(-2, key_range + 2, n_probe).astype(np.int64)
    probe[:3] = [jax_join.KEY_SENTINEL, build[0], build[-1]]
    return build, valid, probe


@pytest.mark.parametrize("seed,key_range", [(1, 1000), (2, 40), (3, 7)])
def test_lookup_join_matches_jax(seed, key_range):
    """Unique and (for small key ranges) tied build keys: the same
    build-row index everywhere (the stable argsort) and the same matches."""
    build, valid, probe = _keys(seed, 300, 2000, key_range)
    if key_range == 1000:
        build = np.random.default_rng(seed).permutation(1000)[:300].astype(np.int64)
    jrow, jmatch = jax_join.lookup_join(jnp.asarray(build), jnp.asarray(valid), jnp.asarray(probe))
    prow, pmatch = port_join.lookup_join(torch.from_numpy(build), torch.from_numpy(valid), torch.from_numpy(probe))
    np.testing.assert_array_equal(pmatch.numpy(), np.asarray(jmatch))
    np.testing.assert_array_equal(prow.numpy(), np.asarray(jrow))
    assert port_join.KEY_SENTINEL == int(jax_join.KEY_SENTINEL)


@pytest.mark.parametrize("seed,key_range,max_dup", [(4, 50, 16), (5, 7, 80), (6, 500, 4)])
def test_range_join_matches_jax(seed, key_range, max_dup):
    """Ties keep build-row order in the slots (the selection's row order)."""
    build, valid, probe = _keys(seed, 400, 1500, key_range)
    counts = np.bincount(build[valid], minlength=key_range)
    max_dup = max(max_dup, int(counts.max())) if key_range < 100 else max_dup
    jrow, jmatch = jax_join.range_join(jnp.asarray(build), jnp.asarray(valid), jnp.asarray(probe), max_dup)
    prow, pmatch = port_join.range_join(torch.from_numpy(build), torch.from_numpy(valid), torch.from_numpy(probe),
                                        max_dup)
    np.testing.assert_array_equal(pmatch.numpy(), np.asarray(jmatch))
    np.testing.assert_array_equal(prow.numpy(), np.asarray(jrow))
    if key_range < 100:
        # every valid build row with the probe's key lands in a slot once
        got = pmatch.numpy().sum(axis=1)
        want = np.array([counts[k] if 0 <= k < key_range else 0 for k in probe])
        np.testing.assert_array_equal(got, want)


def test_range_join_end_clip_no_double_match():
    """A run ending at the build array's tail does not re-match its last row
    through the clamped index."""
    args = ([1, 2, 2, 3], [True] * 4, [3, 2])
    prow, pmatch = port_join.range_join(torch.tensor(args[0]), torch.tensor(args[1]), torch.tensor(args[2]), 2)
    jrow, jmatch = jax_join.range_join(jnp.asarray(args[0], dtype=jnp.int64), jnp.asarray(args[1]),
                                       jnp.asarray(args[2], dtype=jnp.int64), 2)
    assert pmatch.tolist() == [[True, False], [True, True]] == np.asarray(jmatch).tolist()
    assert prow.tolist() == np.asarray(jrow).tolist()


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_hash_dest_bit_for_bit(ndev):
    rng = np.random.default_rng(9)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1 << 14, dtype=np.int64)
    keys[:8] = [0, -1, 1, np.iinfo(np.int64).min, np.iinfo(np.int64).max, 19920101, -(1 << 62), 1 << 33]
    assert (keys < 0).sum() > 1000  # the top bit is set on many keys
    want = np.asarray(jax_ex.hash_dest(jnp.asarray(keys), ndev))
    got = port_ex.hash_dest(torch.from_numpy(keys), ndev)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the int32 key path (a dictionary-decoded INT column widened to int64)
    k32 = keys.astype(np.int32).astype(np.int64)
    np.testing.assert_array_equal(port_ex.hash_dest(torch.from_numpy(k32), ndev).numpy(),
                                  np.asarray(jax_ex.hash_dest(jnp.asarray(k32), ndev)))


@pytest.mark.parametrize("capacity", [5, 37, 200])
def test_hash_repartition_one_device_matches_jax(capacity):
    """ndev = 1 keeps the stable bucketing, the capacity drop and the
    overflow count of the JAX function on a one-device mesh."""
    rng = np.random.default_rng(capacity)
    n = 64
    payload = {"k": rng.integers(0, 1000, n).astype(np.int64), "v": rng.integers(-50, 50, n).astype(np.int32),
               "m": rng.random(n) < 0.7}
    ok = rng.random(n) < 0.8
    dest = np.zeros(n, dtype=np.int32)
    mesh = jax_mesh.default_mesh(num_devices=1)

    def body(arrays, d, o):
        recv, valid, ovf = jax_ex.hash_repartition(arrays, d, o, 1, capacity, "seg")
        return recv, valid, ovf

    fn = shard_map_compat(body, mesh=mesh, in_specs=({k: P("seg") for k in payload}, P("seg"), P("seg")),
                          out_specs=({k: P("seg") for k in payload}, P("seg"), P()))
    jrecv, jvalid, jovf = fn({k: jnp.asarray(v) for k, v in payload.items()}, jnp.asarray(dest), jnp.asarray(ok))
    precv, pvalid, povf = port_ex.hash_repartition(
        {k: torch.from_numpy(v) for k, v in payload.items()}, torch.from_numpy(dest), torch.from_numpy(ok), 1, capacity)
    assert int(povf) == int(jovf) == max(0, int(ok.sum()) - capacity)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    for k in payload:
        np.testing.assert_array_equal(precv[k].numpy(), np.asarray(jrecv[k]), err_msg=k)


def test_broadcast_rows_is_the_identity_at_one_device():
    side = {"key": torch.arange(5), "ok": torch.ones(5, dtype=torch.bool)}
    assert port_ex.broadcast_rows(side) is side


def test_aliased_view_shares_storage():
    """A self-join facade renames the columns and shares the device cache:
    its entries are the base table's tensors, not a second copy."""
    schema = port_schema.Schema("dates", [port_schema.FieldSpec("d_key", port_schema.DataType.INT),
                                          port_schema.FieldSpec("d_year", port_schema.DataType.INT)])
    t = PortStacked.build(schema, {"d_key": np.arange(100), "d_year": 1992 + np.arange(100) // 20}, 4)
    v = t.aliased_view("d1")
    assert v.column_names == ["d1$d_key", "d1$d_year"] and v.schema.name == "dates@d1"
    assert v.column("d1$d_year").codes is t.column("d_year").codes
    base, _ = t.to_device("cpu", ["d_key", "d_year"], with_valid=False)
    view, _ = v.to_device("cpu", ["d1$d_key", "d1$d_year"], with_valid=False)
    for a, b in (("d_key", "d1$d_key"), ("d_year", "d1$d_year")):
        assert set(base[a]) == set(view[b])
        assert all(base[a][k] is view[b][k] for k in base[a])
    t.release_device()
    assert not v._device_cache
