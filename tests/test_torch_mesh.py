"""The port's device mesh (pinot_tpu_torch/parallel/mesh.py) and its
exchanges against the JAX package on the 8-device CPU mesh.

The mesh helpers keep the JAX package's shapes and errors; a port mesh is an
array of device positions, here eight positions of the CPU.  The folds take
the per-position partials as a list in global position order and must give
the bits the JAX collectives give under shard_map on the 1-D, 8x1, 2x4 and
4x2 meshes: psum_ordered on float64 partials, the hierarchical psum on
int64, pmin and pmax on both.  hash_repartition at ndev 8 must hand every
position the rows, validity mask and overflow the JAX all_to_all hands its
device, bit for bit.  The shuffle's overflow back-pressure must build as
many plans as the JAX engine on the same tables.  Inputs come from numpy
seeds; every comparison is exact.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from pinot_tpu.mse import exchange as jax_ex
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.engine import shard_map_compat
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.mse import exchange as port_ex
from pinot_tpu_torch.parallel import mesh as port_mesh
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS

TOPOLOGIES = [None, (8, 1), (2, 4), (4, 2)]
TOPO_IDS = ["1d", "8x1", "2x4", "4x2"]


def _meshes(topology):
    """(JAX mesh, port mesh of 8 CPU positions) of one topology."""
    if topology is None:
        return jax_mesh.default_mesh(), port_mesh.default_mesh(device="cpu", num_devices=8)
    r, s = topology
    return jax_mesh.make_mesh2d(r, s), port_mesh.make_mesh2d(r, s, device="cpu")


# -- (a) the helpers' shapes and errors ------------------------------------
def test_mesh2d_divisibility_error():
    for make in (jax_mesh.make_mesh2d, lambda *a: port_mesh.make_mesh2d(*a, num_devices=8, device="cpu")):
        with pytest.raises(ValueError, match="not divisible into 3 replica rows"):
            make(3)
        with pytest.raises(ValueError, match="needs 6 devices, have 8"):
            make(2, 3)


def test_replica_rows_shapes():
    rows = port_mesh.replica_rows(port_mesh.make_mesh2d(2, 4, device="cpu"))
    jrows = jax_mesh.replica_rows(jax_mesh.make_mesh2d(2, 4))
    assert len(rows) == len(jrows) == 2
    assert all(tuple(m.axis_names) == ("shard",) for m in rows)
    assert [m.shape for m in rows] == [m.devices.shape for m in jrows] == [(4,), (4,)]
    # the rows partition the parent's positions disjointly (one device here)
    ids = [i for m in rows for i in m.position_ids]
    assert sorted(ids) == list(range(8))
    assert {str(d) for m in rows for d in m.positions} == {"cpu"}


@pytest.mark.parametrize("topology", TOPOLOGIES, ids=TOPO_IDS)
def test_mesh_shapes_match_jax(topology):
    jm, pm = _meshes(topology)
    assert pm.shape == jm.devices.shape and pm.size == 8
    assert port_mesh.data_axes(pm) == jax_mesh.data_axes(jm)
    assert pm.position_ids == list(range(8))
    assert port_mesh.normalize_axes("seg") == jax_mesh.normalize_axes("seg") == ("seg",)
    assert port_mesh.DATA_AXES == jax_mesh.DATA_AXES and port_mesh.SEG_AXIS == jax_mesh.SEG_AXIS


def test_default_mesh_on_the_cpu():
    m = port_mesh.default_mesh(device="cpu", num_devices=8)
    assert m.axis_names == ("seg",) and m.shape == (8,)
    assert port_mesh.default_mesh(device="cpu").size == 1
    assert port_mesh.replica_rows(m) == [m]
    assert port_mesh.make_mesh2d(2, device="cpu").shape == (2, 1)


# -- (g) no CUDA, no default --------------------------------------------------
def test_defaults_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_mesh2d(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortDist()
    with pytest.raises(ValueError, match="mesh or a device"):
        PortDist(device="cpu", mesh=port_mesh.default_mesh(device="cpu"))


def test_register_table_needs_divisible_shards():
    schema = port_schema.Schema("t", [port_schema.FieldSpec("k", port_schema.DataType.INT)])
    t = PortStacked.build(schema, {"k": np.arange(100)}, 3)
    e = PortDist(mesh=port_mesh.default_mesh(device="cpu", num_devices=2), hbm_cache_bytes=0)
    with pytest.raises(ValueError, match="num_shards=3 not divisible by mesh size 2"):
        e.register_table("t", t)


# -- (b) the folds against the JAX collectives ---------------------------------
def _jax_fold(jm, fold, parts: np.ndarray):
    """`fold(x, axes)` under shard_map: device i holds parts[i]."""
    axes = jax_mesh.data_axes(jm)
    axis = axes[0] if len(axes) == 1 else axes

    def body(x):
        return fold(x[0], axis)

    fn = shard_map_compat(body, mesh=jm, in_specs=(P(axis),), out_specs=P())
    return np.asarray(jax.jit(fn)(jnp.asarray(parts)))


@pytest.mark.parametrize("topology", TOPOLOGIES, ids=TOPO_IDS)
def test_folds_bit_identical_to_jax(topology):
    jm, pm = _meshes(topology)
    rng = np.random.default_rng(31)
    # float partials whose sum depends on the order (mixed magnitudes)
    floats = rng.standard_normal((8, 64)) * np.float64(10.0) ** rng.integers(-8, 9, (8, 64))
    ints = rng.integers(-(1 << 40), 1 << 40, (8, 64), dtype=np.int64)
    shape = pm.shape
    fparts = [torch.from_numpy(x) for x in floats]
    iparts = [torch.from_numpy(x) for x in ints]
    got = port_mesh.psum_ordered(fparts).numpy()
    want = _jax_fold(jm, jax_mesh.psum_ordered, floats)
    assert got.tobytes() == want.tobytes()
    # the ordered sum is the same bits on every topology
    assert got.tobytes() == port_mesh.psum_ordered(fparts).numpy().tobytes()
    for port_fold, jax_fold, parts, host in (
        (port_mesh.psum_hierarchical, jax_mesh.psum_hierarchical, iparts, ints),
        (port_mesh.pmin_hierarchical, jax_mesh.pmin_hierarchical, iparts, ints),
        (port_mesh.pmax_hierarchical, jax_mesh.pmax_hierarchical, iparts, ints),
        (port_mesh.pmin_hierarchical, jax_mesh.pmin_hierarchical, fparts, floats),
        (port_mesh.pmax_hierarchical, jax_mesh.pmax_hierarchical, fparts, floats),
    ):
        got = port_fold(parts, shape).numpy()
        want = _jax_fold(jm, jax_fold, host)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), port_fold.__name__


def test_fold_field_takes_the_jax_rule():
    """A float add folds in order, an int add, min and max hierarchically."""
    rng = np.random.default_rng(5)
    fl = [torch.from_numpy(rng.standard_normal(16) * 1e9) for _ in range(8)]
    it = [torch.from_numpy(rng.integers(-99, 99, 16)) for _ in range(8)]
    for shape in ((8,), (2, 4), (4, 2)):
        assert port_mesh.fold_field("sum", fl, shape).numpy().tobytes() == port_mesh.psum_ordered(fl).numpy().tobytes()
        assert torch.equal(port_mesh.fold_field("count", it, shape), torch.stack(it).sum(0))
        assert torch.equal(port_mesh.fold_field("min", it, shape), torch.stack(it).min(0).values)
        assert torch.equal(port_mesh.fold_field("max", fl, shape), torch.stack(fl).max(0).values)


# -- (e) the exchanges against the JAX collectives ------------------------------
@pytest.mark.parametrize("capacity", [3, 9, 40])
def test_hash_repartition_eight_positions_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    ndev, n = 8, 40  # rows a position
    payload = {"k": rng.integers(0, 1000, ndev * n).astype(np.int64),
               "v": rng.integers(-50, 50, ndev * n).astype(np.int32),
               "m": rng.random(ndev * n) < 0.7}
    ok = rng.random(ndev * n) < 0.8
    dest = np.asarray(jax_ex.hash_dest(jnp.asarray(payload["k"]), ndev))
    jm = jax_mesh.default_mesh()

    def body(arrays, d, o):
        return jax_ex.hash_repartition(arrays, d, o, ndev, capacity, "seg")

    fn = shard_map_compat(body, mesh=jm, in_specs=({k: P("seg") for k in payload}, P("seg"), P("seg")),
                          out_specs=({k: P("seg") for k in payload}, P("seg"), P()))
    jrecv, jvalid, jovf = jax.jit(fn)({k: jnp.asarray(v) for k, v in payload.items()}, jnp.asarray(dest),
                                      jnp.asarray(ok))
    cut = [slice(p * n, (p + 1) * n) for p in range(ndev)]
    pdest = [port_ex.hash_dest(torch.from_numpy(payload["k"][c]), ndev) for c in cut]
    assert all(np.array_equal(d.numpy(), dest[c]) for d, c in zip(pdest, cut))
    precv, pvalid, povf = port_ex.hash_repartition(
        [{k: torch.from_numpy(v[c]) for k, v in payload.items()} for c in cut], pdest,
        [torch.from_numpy(ok[c]) for c in cut], ndev, capacity)
    assert int(povf) == int(jovf)
    width = ndev * capacity  # rows a position receives
    for j in range(ndev):
        mine = slice(j * width, (j + 1) * width)
        np.testing.assert_array_equal(pvalid[j].numpy(), np.asarray(jvalid)[mine])
        for k in payload:
            np.testing.assert_array_equal(precv[j][k].numpy(), np.asarray(jrecv[k])[mine], err_msg=k)


def test_broadcast_rows_gathers_in_mesh_order():
    rng = np.random.default_rng(2)
    parts = [{"key": torch.from_numpy(rng.integers(0, 99, 5)), "ok": torch.from_numpy(rng.random(5) < 0.5)}
             for _ in range(8)]
    got = port_ex.broadcast_rows(parts)
    assert len(got) == 8 and all(g is got[0] for g in got)  # one device: one concatenation
    for k in ("key", "ok"):
        assert torch.equal(got[0][k], torch.cat([p[k] for p in parts]))
    assert port_ex.broadcast_rows(parts[:1]) == parts[:1]


def _ssb(pkg_schema, n_fact=5000, n_dim=400):
    """tests/test_mse_join.py's toy SSB (lineorder + dates), from its seed."""
    rng = np.random.default_rng(7)
    datekeys = (19920101 + np.arange(n_dim) * 7).astype(np.int64)
    dates = {"d_datekey": datekeys, "d_year": 1992 + (np.arange(n_dim) // 53).astype(np.int64),
             "d_month": 1 + (np.arange(n_dim) % 12).astype(np.int64)}
    lineorder = {
        "lo_orderdate": rng.choice(np.concatenate([datekeys, datekeys[:1] - 99]), n_fact).astype(np.int64),
        "lo_revenue": rng.integers(1, 10_000, n_fact).astype(np.int64),
        "lo_discount": rng.integers(0, 11, n_fact).astype(np.int64),
        "lo_region": rng.choice(["asia", "europe", "americas"], n_fact),
    }
    S, T = pkg_schema.Schema, pkg_schema.DataType
    f = pkg_schema.FieldSpec
    return ((S("lineorder", [f("lo_orderdate", T.INT), f("lo_revenue", T.LONG, role=pkg_schema.FieldRole.METRIC),
                             f("lo_discount", T.INT, role=pkg_schema.FieldRole.METRIC),
                             f("lo_region", T.STRING)]), lineorder),
            (S("dates", [f("d_datekey", T.INT), f("d_year", T.INT), f("d_month", T.INT)]), dates))


SHUFFLE_SQL = ("SET joinStrategy = 'shuffle'; SET shuffleSlack = 0.01; SELECT d_year, SUM(lo_revenue) "
               "FROM lineorder JOIN dates ON lo_orderdate = d_datekey GROUP BY d_year ORDER BY d_year LIMIT 100")
CAP_SQL = ("SET joinStrategy = 'shuffle'; SET shuffleSlack = 0.01; SET shuffleSlackCap = 0.01; "
           "SELECT d_year, SUM(lo_revenue) FROM lineorder JOIN dates ON lo_orderdate = d_datekey GROUP BY d_year")


def test_shuffle_retries_match_jax_plan_count():
    """test_mse_join.py's overflow shapes on 8 positions: the doubled-slack
    retries end in the JAX engine's rows after as many plans, and the cap
    refuses the query in both packages."""
    from pinot_tpu.utils.metrics import METRICS as JAX_METRICS

    out = {}
    for name, pkg_schema, eng, stacked in (
        ("jax", jax_schema, JaxDist(), JaxStacked),
        ("port", port_schema, PortDist(mesh=port_mesh.default_mesh(device="cpu", num_devices=8),
                                       hbm_cache_bytes=0), PortStacked),
    ):
        (ls, lo), (ds, dates) = _ssb(pkg_schema)
        eng.register_table("lineorder", stacked.build(ls, lo, 8))
        eng.register_table("dates", stacked.build(ds, dates, 8))
        metrics = JAX_METRICS if name == "jax" else PORT_METRICS
        before = metrics.counter("mse.exchangeOverflowRetries").value
        rows = eng.query(SHUFFLE_SQL).rows
        retries = metrics.counter("mse.exchangeOverflowRetries").value - before
        with pytest.raises(RuntimeError, match="shuffleSlackCap"):
            eng.query(CAP_SQL)
        plans = len(eng._mse()._plan_cache)
        out[name] = ([(int(a), int(b)) for a, b in rows], retries, plans)
    assert out["port"] == out["jax"] and out["port"][1] > 0
