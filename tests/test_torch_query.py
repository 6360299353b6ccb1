"""The PyTorch port's single-table SQL slice against the JAX package.

One multi-segment table (3 segments, nulls, a range index, an inverted
index, a sorted column) is registered in pinot_tpu's QueryEngine and in
pinot_tpu_torch's QueryEngine(device="cpu"), built by each package's own
builder from the same numpy data.  Every query of the SQL set must return
the same rows from both.  Tolerance: rows compare EXACTLY — including
integer-valued SUMs, which are f64 on both sides — except the cells marked
approximate (aggregates of float columns, AVG, VAR*, STDDEV*), which compare
with rtol=1e-12 because the two packages sum floats in different orders.
The port also matches a sqlite3 golden on the same data (tests/golden.py).
"""
import math

import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.ops import pallas_scan
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.ops import fused_scan
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema

from golden import assert_same_rows, sqlite_from_data

N = 3000
CITIES = ["sf", "nyc", "chi", "la", "sea", "pdx", "atx"]
TAGS = ["a", "b", "c", None]


def make_data(seed, n=N):
    rng = np.random.default_rng(seed)
    return {
        "city": rng.choice(CITIES, n).astype(object),
        "tag": np.asarray([TAGS[i] for i in rng.integers(0, len(TAGS), n)], dtype=object),
        "year": rng.integers(2000, 2024, n).astype(np.int32),
        "day": rng.integers(0, 366, n).astype(np.int32),
        "v": rng.integers(-50, 1000, n),
        "big": rng.integers(-(1 << 40), 1 << 40, n),
        "price": np.where(rng.random(n) < 0.15, np.nan, np.round(rng.random(n) * 100, 3)),
    }


def make_schema(S, name="t"):
    return S.Schema(
        name,
        [
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("tag", S.DataType.STRING, nullable=True),
            S.FieldSpec("year", S.DataType.INT),
            S.FieldSpec("day", S.DataType.INT),
            S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("big", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("price", S.DataType.DOUBLE, role=S.FieldRole.METRIC, nullable=True),
        ],
    )


def make_config(C, name="t", indexed=True):
    if not indexed:
        return C.TableConfig(name)
    return C.TableConfig(
        name,
        indexing=C.IndexingConfig(
            inverted_index_columns=["city"], range_index_columns=["year"], sorted_column="day"
        ),
    )


def build_engines(tables):
    """tables: {name: (indexed, [data dicts])} -> (jax engine, port engine)."""
    jax_engine = JaxEngine()
    port_engine = PortEngine(device="cpu")
    for name, (indexed, datas) in tables.items():
        js, jc = make_schema(jax_schema, name), make_config(jax_config, name, indexed)
        ts, tc = make_schema(port_schema, name), make_config(port_config, name, indexed)
        jax_engine.register_table(js, jc)
        port_engine.register_table(ts, tc)
        for i, d in enumerate(datas):
            jax_engine.add_segment(name, jax_build(js, dict(d), f"{name}{i}", table_config=jc))
            port_engine.add_segment(name, port_build(ts, dict(d), f"{name}{i}", table_config=tc))
    return jax_engine, port_engine


@pytest.fixture(scope="module")
def engines():
    datas = [make_data(seed) for seed in (1, 2, 3)]
    datas[2]["city"][:100] = "den"  # segment 2's city dictionary differs
    jax_engine, port_engine = build_engines({"t": (True, datas), "plain": (False, datas)})
    merged = {k: np.concatenate([d[k] for d in datas]) for k in datas[0]}
    nulls = {"price": np.isnan(merged["price"]), "tag": np.asarray([v is None for v in merged["tag"]])}
    conn = sqlite_from_data("t", merged, nulls)
    return jax_engine, port_engine, conn


# (sql, approximate cell indexes, ordered, sqlite sql: None = same text, False = no golden)
SQL_SET = [
    ("SELECT COUNT(*) FROM t", (), False, None),
    ("SELECT SUM(v), MIN(v), MAX(v), AVG(v) FROM t", (3,), False, None),
    ("SELECT SUM(v), COUNT(*) FROM t WHERE year > 2010", (), False, None),
    ("SELECT SUM(v) FROM t WHERE city = 'sf'", (), False, None),
    ("SELECT SUM(price), COUNT(price), AVG(price) FROM t", (0, 2), False, None),
    ("SELECT SUM(v), COUNT(*), MIN(v) FROM t WHERE city = 'zzz'", (), False, None),
    ("SELECT COUNT(*) FROM t WHERE (city = 'sf' OR city = 'nyc') AND NOT (year < 2010)", (), False, None),
    ("SELECT COUNT(*) FROM t WHERE city IN ('sf', 'den', 'zzz')", (), False, None),
    ("SELECT COUNT(*) FROM t WHERE city NOT IN ('sf', 'den')", (), False, None),
    ("SELECT COUNT(*), AVG(v) FROM t WHERE v BETWEEN 0 AND 500", (1,), False, None),
    ("SELECT COUNT(*) FROM t WHERE REGEXP_LIKE(city, '^s')", (), False,
     "SELECT COUNT(*) FROM t WHERE city LIKE 's%'"),
    ("SELECT COUNT(*) FROM t WHERE city LIKE 's%'", (), False, None),
    ("SELECT COUNT(*) FROM t WHERE price IS NULL", (), False, None),
    ("SELECT COUNT(*) FROM t WHERE price IS NOT NULL", (), False, None),
    ("SELECT VARIANCE(v), STDDEV(v), VARSAMP(v), STDDEVSAMP(v), MINMAXRANGE(v) FROM t",
     (0, 1, 2, 3), False, False),
    ("SELECT city, SUM(v) FROM t GROUP BY city LIMIT 100", (), False, None),
    ("SELECT city, year, COUNT(*), AVG(v) FROM t GROUP BY city, year LIMIT 1000", (3,), False, None),
    ("SELECT year, SUM(v) FROM t WHERE city = 'sf' GROUP BY year LIMIT 100", (), False, None),
    ("SELECT city, SUM(v) FROM t GROUP BY city HAVING SUM(v) > 60000 LIMIT 100", (), False, None),
    ("SELECT city, SUM(v) FROM t GROUP BY city ORDER BY SUM(v) DESC LIMIT 3", (), True, None),
    ("SELECT city, AVG(price) FROM t GROUP BY city LIMIT 100", (1,), False, None),
    ("SELECT tag, COUNT(*), SUM(big) FROM t GROUP BY tag LIMIT 100", (), False, None),
    ("SELECT SUM(big), MIN(big), MAX(big) FROM t WHERE day BETWEEN 50 AND 200", (), False, None),
    ("SELECT year, MIN(price), MAX(price), SUM(price) FROM t WHERE year >= 2005 "
     "GROUP BY year ORDER BY year LIMIT 50", (3,), True, None),
    ("SELECT day, COUNT(*) FROM t WHERE city != 'chi' GROUP BY day "
     "ORDER BY COUNT(*) DESC, day LIMIT 5", (), True, None),
    ("SELECT COUNT(*) FROM t WHERE tag IS NULL OR year = 2001", (), False, None),
    ("SELECT v, COUNT(*) FROM t WHERE v < 10 GROUP BY v LIMIT 100", (), False, None),
    ("SELECT year, COUNT(*) AS c FROM t GROUP BY year HAVING c > 350 ORDER BY c DESC, year LIMIT 5",
     (), True, None),
    # numGroupsLimit trims per segment: no sqlite equivalent
    ("SET numGroupsLimit = 5; SELECT day, SUM(v) FROM t GROUP BY day ORDER BY SUM(v) DESC LIMIT 3",
     (), True, False),
    # Both packages share one three-valued-logic fault here (a NOT over an
    # AND whose nullable child is NULL where the other child is false): the
    # port mirrors the reference, sqlite disagrees (ROADMAP, Queue 3).
    ("SELECT COUNT(*) FROM t WHERE NOT (city = 'sf' AND price > 50)", (), False, False),
]


def _sort_key(row):
    return tuple((v is None, type(v).__name__, v if v is not None else 0) for v in row)


def assert_rows_match(got, want, approx=(), ordered=False):
    """Exact cell equality (value and Python type), rtol=1e-12 on the cells
    listed in `approx`."""
    assert len(got) == len(want), (got[:5], want[:5])
    if not ordered:
        got, want = sorted(got, key=_sort_key), sorted(want, key=_sort_key)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if i in approx and a is not None and b is not None:
                assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (i, a, b, g, w)
            else:
                assert a == b and type(a) is type(b), (i, a, b, g, w)


@pytest.mark.parametrize("sql,approx,ordered,lite", SQL_SET, ids=[q[0][:60] for q in SQL_SET])
def test_sql_set_matches_jax(engines, sql, approx, ordered, lite):
    jax_engine, port_engine, conn = engines
    want = jax_engine.query(sql)
    got = port_engine.query(sql)
    assert_rows_match(got.rows, want.rows, approx, ordered)
    assert got.stats.filter_index_uses == want.stats.filter_index_uses
    if lite is not False:
        assert_same_rows(got.rows, conn.execute(lite or sql).fetchall(), ordered=ordered)


# test_index_filters.py's aggregation queries: the indexed table must ride
# the same index as the JAX package and answer as the unindexed one
INDEX_QUERIES = [
    ("SELECT COUNT(*), SUM(v) FROM {t} WHERE city = 'sf'", ("city", "inverted")),
    ("SELECT COUNT(*), SUM(v) FROM {t} WHERE city IN ('sf', 'nyc', 'la')", ("city", "inverted")),
    ("SELECT COUNT(*), SUM(v) FROM {t} WHERE city != 'chi'", ("city", "inverted")),
    ("SELECT COUNT(*), SUM(v) FROM {t} WHERE year > 2010", ("year", "range")),
    ("SELECT COUNT(*), SUM(v) FROM {t} WHERE year BETWEEN 2005 AND 2012", ("year", "range")),
    ("SELECT COUNT(*), SUM(v) FROM {t} WHERE day < 100", ("day", "sorted")),
    ("SELECT COUNT(*), SUM(v) FROM {t} WHERE day = 250", ("day", "sorted")),
    (
        "SELECT year, COUNT(*) FROM {t} WHERE city = 'sf' AND day >= 180 "
        "GROUP BY year ORDER BY year LIMIT 25",
        ("city", "inverted"),
    ),
]


@pytest.mark.parametrize("sql_tpl,expected_use", INDEX_QUERIES)
def test_index_paths_match_jax(engines, sql_tpl, expected_use):
    jax_engine, port_engine, _ = engines
    got_idx = port_engine.query(sql_tpl.format(t="t"))
    want_idx = jax_engine.query(sql_tpl.format(t="t"))
    got_plain = port_engine.query(sql_tpl.format(t="plain"))
    assert got_idx.rows == want_idx.rows == got_plain.rows
    assert expected_use in got_idx.stats.filter_index_uses
    assert got_idx.stats.filter_index_uses == want_idx.stats.filter_index_uses
    assert not got_plain.stats.filter_index_uses


# -- the main path: BASELINE config 2 on a small SSB lineorder ---------------
CONFIG2 = (
    "SELECT lo_orderdate, SUM(lo_revenue), COUNT(*) FROM lineorder "
    "WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500"
)


def lineorder_data(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64),
    }


def lineorder_schema(S):
    return S.Schema(
        "lineorder",
        [
            S.FieldSpec("lo_orderdate", S.DataType.INT),
            S.FieldSpec("lo_quantity", S.DataType.INT),
            S.FieldSpec("lo_discount", S.DataType.INT),
            S.FieldSpec("lo_revenue", S.DataType.LONG, role=S.FieldRole.METRIC),
        ],
    )


@pytest.fixture(scope="module")
def lineorder():
    datas = [lineorder_data(seed, 8192) for seed in (7, 8)]
    jax_engine, port_engine = JaxEngine(), PortEngine(device="cpu")
    for S, C, build, eng in (
        (jax_schema, jax_config, jax_build, jax_engine),
        (port_schema, port_config, port_build, port_engine),
    ):
        schema = lineorder_schema(S)
        cfg = C.TableConfig("lineorder", indexing=C.IndexingConfig(range_index_columns=["lo_quantity"]))
        eng.register_table(schema, cfg)
        for i, d in enumerate(datas):
            eng.add_segment("lineorder", build(schema, dict(d), f"lo{i}", table_config=cfg))
    return jax_engine, port_engine, datas


def _config2_golden(datas):
    od = np.concatenate([d["lo_orderdate"] for d in datas])
    q = np.concatenate([d["lo_quantity"] for d in datas])
    rev = np.concatenate([d["lo_revenue"] for d in datas])
    m = q < 25
    keys, inv = np.unique(od[m], return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, rev[m])
    counts = np.bincount(inv, minlength=len(keys))
    return sorted((int(k), float(s), int(c)) for k, s, c in zip(keys, sums, counts))


def test_config2_main_path(lineorder):
    """The main path: range-index filter, packed 16-bit group key, one
    int_sum entry plus the shared count entry."""
    jax_engine, port_engine, datas = lineorder
    got = port_engine.query(CONFIG2)
    want = jax_engine.query(CONFIG2)
    assert_rows_match(got.rows, want.rows)
    assert sorted(got.rows) == _config2_golden(datas)
    assert got.stats.filter_index_uses == (("lo_quantity", "range"),)
    seg = port_engine.tables["lineorder"].segments[0]
    assert seg.column("lo_orderdate").code_bits == 16
    assert seg.column("lo_revenue").values.dtype == np.int32


def test_config2_through_the_pallas_kernel(lineorder, monkeypatch):
    """With PINOT_TPU_SCAN_BACKEND=interpret the JAX package runs its Pallas
    kernel (interpreted, packed key lanes); the port matches that route too."""
    jax_engine, port_engine, _ = lineorder
    monkeypatch.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
    pallas_scan.scan_backend.cache_clear()
    try:
        assert pallas_scan.scan_backend() == "interpret"
        want = jax_engine.query(CONFIG2)
    finally:
        monkeypatch.delenv("PINOT_TPU_SCAN_BACKEND")
        pallas_scan.scan_backend.cache_clear()
    assert_rows_match(port_engine.query(CONFIG2).rows, want.rows)


def test_cpu_engine_never_launches_the_kernel(lineorder):
    _, port_engine, _ = lineorder
    before = fused_scan.LAUNCHES
    port_engine.query(CONFIG2)
    assert fused_scan.LAUNCHES == before


def test_plan_cache_reuses_closure_across_literals(lineorder):
    _, port_engine, _ = lineorder
    port_planner.plan_cache_clear()
    port_engine.query(CONFIG2)
    size = port_planner.plan_cache_size()
    r2 = port_engine.query(CONFIG2.replace("< 25", "< 40"))
    assert port_planner.plan_cache_size() == size  # same shape: no new plan
    assert r2.rows != port_engine.query(CONFIG2).rows


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT city, v FROM t LIMIT 5",  # selection
        "SELECT SUM(v) FILTER (WHERE city = 'sf') FROM t",  # filtered aggregation
        "SELECT SUM(v * 2) FROM t",  # transform
        "SELECT DISTINCTCOUNTHLL(city) FROM t",  # sketch
        "SET maxDenseGroups = 4; SELECT city, year, SUM(v) FROM t GROUP BY city, year",  # sparse
    ],
)
def test_later_slices_raise_not_implemented(engines, sql):
    _, port_engine, _ = engines
    with pytest.raises(NotImplementedError):
        port_engine.query(sql)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortEngine()
    assert PortEngine(device="cpu").device == torch.device("cpu")
