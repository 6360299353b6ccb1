"""The port's sketch aggregations (DISTINCTCOUNT, DISTINCTCOUNTHLL,
PERCENTILE / Est / TDigest) against the JAX package.

The same numpy data goes through both packages: module-level functions
(the device hash, the HLL register rank, the host hash tables, the
percentile bins, every partial field) on the same inputs, and SQL through
each package's QueryEngine (one segment; three segments whose string
dictionaries differ, so the `city` column binds MIXED) and
DistributedEngine (dense and sparse group-by, at one launch and at four).

Tolerances: integer results and every partial field are identical
(presence tables, HLL registers, histograms); float results (percentile
interpolation, covariance-like statistics) agree to rtol 1e-9.  This file
also holds the helpers the other sketch test files share.
"""
import math

import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.query import sketches as jsk
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.query import sketches as psk
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema

from test_torch_dist_engine import _launch_bytes_for, _stacked_pair
from test_torch_dist_engine import make_config as dist_config
from test_torch_dist_engine import make_data as dist_data
from test_torch_dist_engine import make_schema as dist_schema
from test_torch_query import make_config, make_data, make_schema

RTOL = 1e-9


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _same_cell(a, b) -> bool:
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same_cell(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0)
    return a == b and type(a) is type(b)


def assert_same_rows(got, want, ordered=False):
    """Cells equal in value and type; floats (and floats in lists) to rtol 1e-9."""
    assert len(got) == len(want), (got[:3], want[:3])
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert _same_cell(a, b), (a, b, g, w)


def assert_same_partial(jp, pp):
    """Every field of a JAX partial equals the port's exactly."""
    assert set(jp) == set(pp)
    for f in jp:
        a = np.asarray(jp[f])
        b = pp[f].numpy() if isinstance(pp[f], torch.Tensor) else np.asarray(pp[f])
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)


def as_jax(x):
    return tuple(jnp.asarray(v) for v in x) if isinstance(x, tuple) else jnp.asarray(x)


def as_port(x):
    return tuple(torch.from_numpy(np.asarray(v)) for v in x) if isinstance(x, tuple) else torch.from_numpy(
        np.asarray(x))


def sse_engines(n=600):
    """{"one": one-segment engines, "multi": three segments (the third's
    city dictionary differs)} as (jax engine, port engine) pairs."""
    datas = [make_data(seed, n) for seed in (11, 12, 13)]
    datas[2]["city"][:40] = "den"
    out = {}
    for label, parts in (("one", datas[:1]), ("multi", datas)):
        je, pe = JaxEngine(), PortEngine(device="cpu")
        js, jc = make_schema(jax_schema), make_config(jax_config)
        ts, tc = make_schema(port_schema), make_config(port_config)
        je.register_table(js, jc)
        pe.register_table(ts, tc)
        for i, d in enumerate(parts):
            je.add_segment("t", jax_build(js, dict(d), f"t{i}", table_config=jc))
            pe.add_segment("t", port_build(ts, dict(d), f"t{i}", table_config=tc))
        out[label] = (je, pe)
    return out


def dist_engines():
    """{"one" | "many": (JAX reference engine, port DistributedEngine)}: the
    JAX DistributedEngine, and for the queries it refuses (pairwise merges
    outside its sparse path) the JAX QueryEngine over one segment of the
    same data (a stacked table has one dictionary per column, as one
    segment does)."""
    js, ps_ = _stacked_pair()
    sse = JaxEngine()
    sch, cfg = dist_schema(jax_schema), dist_config(jax_config)
    sse.register_table(sch, cfg)
    sse.add_segment("t", jax_build(sch, dict(dist_data()), "s0", table_config=cfg))
    out = {}
    for label, lb in (("one", None), ("many", _launch_bytes_for(ps_, 4))):
        je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=lb)
        pe = PortDist(device="cpu", launch_bytes=lb, hbm_cache_bytes=0)
        je.register_table("t", js)
        pe.register_table("t", ps_)
        out[label] = (je, sse, pe)
    return out


def dist_reference_rows(je, sse, sql):
    try:
        return je.query(sql).rows
    except NotImplementedError as e:
        assert "pairwise-merge" in str(e)
        return sse.query(sql).rows


@pytest.fixture(scope="module")
def sse():
    return sse_engines()


@pytest.fixture(scope="module")
def dist():
    return dist_engines()


# ---------------------------------------------------------------------------
# module-level parity
# ---------------------------------------------------------------------------
def _hash_inputs(dtype):
    rng = np.random.default_rng(5)
    n = 1 << 16
    if dtype == "int32":
        x = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        x[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    elif dtype == "int64":
        x = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
        x[:5] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1 << 32]
    else:
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)).astype(np.float64)
        x[:6] = [0.0, -0.0, np.inf, -np.inf, 1e-310, 123456.789]
    return x


@pytest.mark.parametrize("dtype", ["int32", "int64", "float64"])
@pytest.mark.parametrize("width", ["hash32", "hash62"])
def test_device_hash_matches_jax(dtype, width):
    x = _hash_inputs(dtype)
    if width == "hash32":
        want = np.asarray(jsk._device_hash_values(jnp.asarray(x))).astype(np.int64)
        got = psk._device_hash_values(torch.from_numpy(x)).numpy()
    else:
        want = np.asarray(jsk._device_hash62(jnp.asarray(x)))
        got = psk._device_hash62(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_hll_rank_matches_jax_for_every_w():
    """All 2^20 values of w at log2m = 12 (w < 2^20): the JAX package's
    float32 floor(log2 w), including 2^13 and 2^15, where XLA's log2 lands
    just below the integer."""
    log2m = 12
    nbits = 32 - log2m
    w = np.arange(1 << nbits, dtype=np.int64)
    got = psk.hll_rank(torch.from_numpy(w), nbits).numpy()
    np.testing.assert_array_equal(got, _jax_rank(w, nbits))


def _jax_rank(w: np.ndarray, nbits: int) -> np.ndarray:
    """The JAX package's device-hash rank (`_bucket_rho`'s expression)."""
    wj = jnp.asarray(w.astype(np.int32))
    lg = jnp.floor(jnp.log2(jnp.maximum(wj, 1).astype(jnp.float32))).astype(jnp.int32)
    return np.asarray(jnp.where(wj > 0, nbits - lg, nbits + 1))


def test_hll_rank_matches_jax_for_every_float32_w_below_2_27():
    """log2m = 5 (w < 2^27): both ranks read w only through float32(w), so
    one w for each float32 value that some w < 2^27 rounds to covers every
    w: all w < 2^24, every 2nd, 4th and 8th above, and 2^27 - 1 (which
    rounds up to 2^27)."""
    nbits = 27
    reps = [np.arange(1 << 24, dtype=np.int64)]
    reps += [np.arange(1 << k, 1 << (k + 1), 1 << (k - 23), dtype=np.int64) for k in (24, 25, 26)]
    reps.append(np.array([(1 << 27) - 1], dtype=np.int64))
    w = np.concatenate(reps)
    assert np.unique(w.astype(np.float32)).size == w.size  # one w a float32 value
    for chunk in np.array_split(w, 10):
        got = psk.hll_rank(torch.from_numpy(chunk), nbits).numpy()
        np.testing.assert_array_equal(got, _jax_rank(chunk, nbits))


@pytest.mark.parametrize("log2m", [5, 12])
def test_hll_bucket_rho_matches_jax(log2m):
    x = _hash_inputs("int64")
    jb, jr = jsk.DistinctCountHLLFunction(log2m, device_hash=True)._bucket_rho(jnp.asarray(x))
    pb, pr = psk.DistinctCountHLLFunction(log2m, device_hash=True)._bucket_rho(torch.from_numpy(x))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("kind", ["int", "float", "string"])
def test_hll_host_tables_match_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "int":
        vals = np.unique(rng.integers(-(1 << 40), 1 << 40, 5000))
    elif kind == "float":
        vals = np.unique(rng.standard_normal(5000))
    else:
        vals = np.asarray(sorted({f"k{i}" for i in rng.integers(0, 10**6, 3000)}), dtype=object)
    for log2m in (4, 12):
        jb, jr = jsk._hll_host_tables(vals, log2m)
        pb, pr = psk._hll_host_tables(vals, log2m)
        np.testing.assert_array_equal(pb, jb)
        np.testing.assert_array_equal(pr, jr)


def test_percentile_bins_match_jax():
    """float32 binning: subtract, then multiply, both rounded (no FMA)."""
    rng = np.random.default_rng(8)
    lo, hi = 100.0, 999_999.0
    x = np.concatenate([rng.integers(100, 1_000_000, 1 << 16), np.linspace(lo, hi, 4097).round()]).astype(np.int64)
    for bins in (2048, 7):
        jf = jsk.PercentileFunction(95, lo, hi, bins)
        pf = psk.PercentileFunction(95, lo, hi, bins)
        np.testing.assert_array_equal(pf._bin(torch.from_numpy(x)).numpy(), np.asarray(jf._bin(jnp.asarray(x))))


def _bound_pair(name, binding):
    """(jax fn, port fn) bound to the same ColumnBinding."""
    from pinot_tpu.query import functions as jf
    from pinot_tpu_torch.query import functions as pf

    jb = jsk.ColumnBinding(**binding)
    pb = psk.ColumnBinding(**binding)
    return jf.get_agg_function(name).bind_column(jb), pf.get_agg_function(name).bind_column(pb)


_DICT_VALUES = np.arange(0, 3000, 7).astype(np.int64)
PARTIAL_CASES = {
    "distinctcount/dict": ("distinctcount", dict(kind="dict", domain=len(_DICT_VALUES), dict_values=_DICT_VALUES)),
    "distinctcount/rawint": ("distinctcount", dict(kind="rawint", domain=2000, base=-500)),
    "distinctcounthll/dict": ("distinctcounthll", dict(kind="dict", domain=len(_DICT_VALUES),
                                                       dict_values=_DICT_VALUES)),
    "distinctcounthll/raw": ("distinctcounthll", dict(kind="raw")),
    "percentile": ("percentile", dict(kind="raw", min_value=-500, max_value=1499)),
    "percentiletdigest": ("percentiletdigest", dict(kind="raw", min_value=-500.5, max_value=1499.25)),
}


def _partial_inputs(jfn, n=4000, seed=2):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.8
    kind = getattr(jfn, "input_kind", "values")
    if kind == "codes" and getattr(jfn, "domain", 0):
        vals = rng.integers(0, jfn.domain, n).astype(np.int32)
    elif kind == "codes" and getattr(jfn, "bucket_table", None) is not None:
        vals = rng.integers(0, len(jfn.bucket_table), n).astype(np.int32)
    elif kind == "values_offset":
        vals = rng.integers(0, jfn.domain, n).astype(np.int32)
    else:
        vals = rng.integers(-500, 1500, n).astype(np.int64)
    keys = rng.integers(0, 9, n).astype(np.int32)
    return vals, mask, keys


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
@pytest.mark.parametrize("grouped", [False, True])
def test_partials_match_jax(case, grouped):
    name, binding = PARTIAL_CASES[case]
    jfn, pfn = _bound_pair(name, binding)
    vals, mask, keys = _partial_inputs(jfn)
    if grouped:
        jp = jfn.partial_grouped(as_jax(vals), jnp.asarray(mask), jnp.asarray(keys), 9)
        pp = pfn.partial_grouped(as_port(vals), torch.from_numpy(mask), torch.from_numpy(keys), 9)
    else:
        jp = jfn.partial(as_jax(vals), jnp.asarray(mask))
        pp = pfn.partial(as_port(vals), torch.from_numpy(mask))
    assert_same_partial(jp, pp)


def test_cell_budget_message_matches_jax():
    jfn, pfn = _bound_pair("distinctcount", dict(kind="rawint", domain=1 << 20, base=0))
    with pytest.raises(NotImplementedError) as je:
        jfn.partial_grouped(jnp.zeros(4, jnp.int32), jnp.ones(4, bool), jnp.zeros(4, jnp.int32), 100)
    with pytest.raises(NotImplementedError) as pe:
        pfn.partial_grouped(torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                            torch.zeros(4, dtype=torch.int32), 100)
    assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# SQL parity
# ---------------------------------------------------------------------------
SSE_SQL = [
    "SELECT DISTINCTCOUNT(year), DISTINCTCOUNT(city), DISTINCTCOUNTBITMAP(day), "
    "SEGMENTPARTITIONEDDISTINCTCOUNT(tag) FROM t",
    "SELECT DISTINCTCOUNT(v), DISTINCTCOUNTHLL(city), DISTINCTCOUNTHLL(v), DISTINCTCOUNTHLL(price, 6), "
    "DISTINCTCOUNTHLL(big) FROM t WHERE year > 2005",
    "SELECT PERCENTILE(v, 90), PERCENTILEEST(v, 10), PERCENTILETDIGEST(price, 50), PERCENTILE(day) FROM t",
    "SELECT city, DISTINCTCOUNTHLL(v), PERCENTILETDIGEST(v, 95), COUNT(*), SUM(v) FROM t "
    "WHERE year < 2015 GROUP BY city ORDER BY city LIMIT 100",
    "SELECT year, DISTINCTCOUNT(day), DISTINCTCOUNT(v), DISTINCTCOUNTHLL(tag, 4) FROM t GROUP BY year LIMIT 100",
    "SET maxDenseGroups = 4; SELECT year, day, DISTINCTCOUNTHLL(v, 5), PERCENTILE(v, 50), COUNT(*) FROM t "
    "GROUP BY year, day ORDER BY COUNT(*) DESC, year, day LIMIT 50",
    "SELECT city, DISTINCTCOUNT(city) FROM t GROUP BY city LIMIT 10",
]


@pytest.mark.parametrize("layout", ["one", "multi"])
@pytest.mark.parametrize("sql", SSE_SQL, ids=[s[:60] for s in SSE_SQL])
def test_segment_engine_matches_jax(sse, layout, sql):
    je, pe = sse[layout]
    try:
        want = je.query(sql).rows
    except NotImplementedError as e:  # e.g. exact grouped DISTINCTCOUNT over MIXED dictionaries
        with pytest.raises(NotImplementedError) as got:
            pe.query(sql)
        assert str(got.value) == str(e)
        return
    assert_same_rows(pe.query(sql).rows, want, ordered="ORDER BY" in sql)


DIST_SQL = [
    # BASELINE config 3's shape: the sketches beside COUNT/SUM on the fused scan
    "SELECT disc, q, DISTINCTCOUNTHLL(d), PERCENTILETDIGEST(rev, 95), COUNT(*), SUM(rev) FROM t "
    "WHERE q < 25 GROUP BY disc, q ORDER BY disc, q LIMIT 300",
    "SELECT DISTINCTCOUNT(d), DISTINCTCOUNT(rev), DISTINCTCOUNTHLL(rev), DISTINCTCOUNTHLL(city), "
    "PERCENTILEEST(price, 25) FROM t WHERE q < 25",
    "SET maxDenseGroups = 2; SET numGroupsLimit = 2000000; SELECT d, q, disc, DISTINCTCOUNTHLL(rev, 5), "
    "SUM(rev), COUNT(*) FROM t WHERE q < 25 GROUP BY d, q, disc ORDER BY SUM(rev) DESC LIMIT 100",
    "SET maxDenseGroups = 2; SELECT disc, DISTINCTCOUNT(yr), PERCENTILE(rev, 50) FROM t GROUP BY disc "
    "ORDER BY disc LIMIT 20",
]


@pytest.mark.parametrize("batching", ["one", "many"])
@pytest.mark.parametrize("sql", DIST_SQL, ids=[s[:60] for s in DIST_SQL])
def test_dist_engine_matches_jax(dist, batching, sql):
    je, sse_ref, pe = dist[batching]
    assert_same_rows(pe.query(sql).rows, dist_reference_rows(je, sse_ref, sql), ordered="ORDER BY" in sql)
