"""Selection queries and window functions: the port against the JAX package.

Three segments (the third with a city the others lack, a nullable string
and a nullable double column, a unique `id`) go into pinot_tpu's
QueryEngine and pinot_tpu_torch's QueryEngine(device="cpu"), each built by
its own package's builder from the same numpy data; the StackedTable pair of
tests/test_torch_dist_engine.py goes into both DistributedEngines.

Tolerance: selection rows must be EQUAL IN ORDER to the JAX package's, cell
by cell with the Python type; float cells computed by a window aggregate
(SUM/AVG/MIN/MAX OVER) compare with rtol=1e-12, as both packages sum floats
in their own order.  Where sqlite3 answers the same SQL the same way, the
port's rows must also equal sqlite's (as a multiset: sqlite leaves the row
order of ties and of unordered selections open).
"""
import math

import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.ops import pallas_scan
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import parse_query as port_parse

from golden import assert_same_rows, sqlite_from_data
from test_torch_dist_engine import _launch_bytes_for, _stacked_pair

N = 1200
CITIES = ["sf", "nyc", "chi", "la", "sea"]


def make_data(seed, start, n=N):
    rng = np.random.default_rng(seed)
    return {
        "id": np.arange(start, start + n, dtype=np.int32),
        "city": rng.choice(CITIES, n).astype(object),
        "tag": np.asarray([[None, "a", "b", "c"][i] for i in rng.integers(0, 4, n)], dtype=object),
        "day": rng.integers(0, 60, n).astype(np.int32),
        "v": rng.integers(-20, 80, n).astype(np.int64),
        "price": np.where(rng.random(n) < 0.2, np.nan, np.round(rng.random(n) * 100, 2)),
    }


def make_schema(S):
    return S.Schema(
        "t",
        [
            S.FieldSpec("id", S.DataType.INT),
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("tag", S.DataType.STRING, nullable=True),
            S.FieldSpec("day", S.DataType.INT),
            S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("price", S.DataType.DOUBLE, role=S.FieldRole.METRIC, nullable=True),
        ],
    )


@pytest.fixture(scope="module")
def engines():
    datas = [make_data(seed, i * N) for i, seed in enumerate((21, 22, 23))]
    datas[2]["city"][:50] = "den"
    jax_engine, port_engine = JaxEngine(), PortEngine(device="cpu")
    for S, C, build, eng in ((jax_schema, jax_config, jax_build, jax_engine),
                             (port_schema, port_config, port_build, port_engine)):
        schema = make_schema(S)
        cfg = C.TableConfig("t", indexing=C.IndexingConfig(inverted_index_columns=["city"],
                                                            range_index_columns=["day"]))
        eng.register_table(schema, cfg)
        for i, d in enumerate(datas):
            eng.add_segment("t", build(schema, dict(d), f"t{i}", table_config=cfg))
    merged = {k: np.concatenate([d[k] for d in datas]) for k in datas[0]}
    nulls = {"price": np.isnan(merged["price"]), "tag": np.asarray([v is None for v in merged["tag"]])}
    return jax_engine, port_engine, sqlite_from_data("t", merged, nulls)


def assert_rows_equal(got, want, approx=()):
    assert len(got) == len(want), (len(got), len(want), got[:3], want[:3])
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if i in approx and isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-12) or (a != a and b != b), (i, a, b, g, w)
            else:
                assert a == b and type(a) is type(b), (i, a, b, g, w)


# (sql, approximate cells, sqlite: None = same text, False = no golden)
SELECTIONS = [
    ("SELECT * FROM t WHERE v < -15 ORDER BY id LIMIT 20", (), None),
    ("SELECT city, v, price FROM t WHERE day = 7 LIMIT 500", (), None),
    ("SELECT id, city FROM t WHERE city = 'den' LIMIT 5 OFFSET 2", (), False),  # segment order: no golden
    ("SELECT city, v * 2, price + 1 FROM t WHERE day < 30 ORDER BY v * 2 DESC, id LIMIT 25", (), None),
    ("SELECT id, price FROM t ORDER BY price NULLS FIRST, id LIMIT 30", (), None),
    ("SELECT id, price FROM t ORDER BY price DESC NULLS LAST, id LIMIT 30", (), None),
    # NULLS LAST is the default here, NULLS FIRST in sqlite
    ("SELECT id, tag FROM t ORDER BY tag, id LIMIT 40 OFFSET 15", (),
     "SELECT id, tag FROM t ORDER BY tag NULLS LAST, id LIMIT 40 OFFSET 15"),
    ("SELECT id, tag FROM t ORDER BY tag DESC NULLS FIRST, id DESC LIMIT 12", (), None),
    ("SELECT city, id FROM t WHERE city IN ('sf', 'den') ORDER BY city DESC, id LIMIT 100 OFFSET 7", (), None),
    ("SELECT id, day FROM t ORDER BY MOD(id, 7), id DESC LIMIT 20", (), None),
    ("SELECT city FROM t ORDER BY v DESC, id LIMIT 10", (), None),
    # division is always double here, integer division in sqlite
    ("SELECT id, v / 4, ABS(v - 30) FROM t WHERE v BETWEEN 10 AND 12 ORDER BY id DESC LIMIT 15", (),
     "SELECT id, v / 4.0, ABS(v - 30) FROM t WHERE v BETWEEN 10 AND 12 ORDER BY id DESC LIMIT 15"),
    # a CASE over a nullable column is NULL where the column is (the JAX
    # package's rule for expression items); sqlite says 'lo' there
    ("SELECT id, CASE WHEN price > 50 THEN 'hi' ELSE 'lo' END FROM t ORDER BY id LIMIT 30", (), False),
    ("SELECT id, CASE WHEN v > 50 THEN v * 10 WHEN v < 0 THEN 0 ELSE v END FROM t ORDER BY id LIMIT 40", (), None),
    ("SELECT id, UPPER(city), LENGTH(city) FROM t WHERE day = 3 ORDER BY id LIMIT 30", (), None),
    ("SELECT id FROM t WHERE UPPER(city) = 'SF' AND LENGTH(tag) = 1 ORDER BY id DESC LIMIT 10", (), None),
    ("SELECT id, price FROM t WHERE price * 2 > 150 ORDER BY price, id LIMIT 10", (), None),
]

WINDOWS = [
    ("SELECT id, city, ROW_NUMBER() OVER (PARTITION BY city ORDER BY v DESC, id) FROM t WHERE day = 4 "
     "LIMIT 5000", (), None),
    ("SELECT id, city, v, RANK() OVER (PARTITION BY city ORDER BY v), DENSE_RANK() OVER (PARTITION BY city "
     "ORDER BY v) FROM t WHERE day < 6 LIMIT 5000", (), None),
    ("SELECT id, LAG(v) OVER (PARTITION BY city ORDER BY id), LEAD(v, 2, -1) OVER (PARTITION BY city ORDER BY id) "
     "FROM t WHERE day < 5 LIMIT 5000", (), None),
    ("SELECT id, FIRST_VALUE(v) OVER (PARTITION BY city ORDER BY id), LAST_VALUE(v) OVER (PARTITION BY city "
     "ORDER BY id ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) FROM t WHERE day < 5 LIMIT 5000",
     (), None),
    ("SELECT id, NTILE(4) OVER (PARTITION BY city ORDER BY id) FROM t WHERE day < 5 LIMIT 5000", (), None),
    ("SELECT id, SUM(v) OVER (PARTITION BY city ORDER BY id ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING), "
     "AVG(v) OVER (ORDER BY id ROWS 3 PRECEDING) FROM t WHERE day < 5 LIMIT 5000", (1, 2), None),
    ("SELECT id, SUM(v) OVER (PARTITION BY city ORDER BY day RANGE BETWEEN 2 PRECEDING AND CURRENT ROW), "
     "COUNT(*) OVER (PARTITION BY city ORDER BY day) FROM t WHERE day < 12 LIMIT 5000", (1,), None),
    ("SELECT id, AVG(v) OVER (PARTITION BY city ORDER BY day RANGE BETWEEN CURRENT ROW AND 3 FOLLOWING) "
     "FROM t WHERE day < 12 LIMIT 5000", (1,), None),
    ("SELECT id, MIN(price) OVER (PARTITION BY city), MAX(v) OVER (PARTITION BY city ORDER BY id ROWS BETWEEN "
     "1 PRECEDING AND 1 FOLLOWING) FROM t WHERE day < 5 LIMIT 5000", (1, 2), None),
    ("SELECT id, SUM(v) OVER (PARTITION BY tag) FROM t WHERE day < 5 LIMIT 5000", (1,), None),
    # the window's ORDER BY key is nullable: both packages rank its text
    # form (NULL as 'None'), which sqlite does not
    ("SELECT id, RANK() OVER (ORDER BY price) FROM t WHERE day < 3 LIMIT 5000", (), False),
    ("SELECT id, v, RANK() OVER (PARTITION BY city ORDER BY v DESC) FROM t WHERE day < 4 ORDER BY id LIMIT 40 "
     "OFFSET 5", (), None),
]


@pytest.mark.parametrize("sql,approx,lite", SELECTIONS + WINDOWS, ids=[q[0][:80] for q in SELECTIONS + WINDOWS])
def test_selection_matches_jax(engines, sql, approx, lite):
    jax_engine, port_engine, conn = engines
    want, got = jax_engine.query(sql), port_engine.query(sql)
    assert got.columns == want.columns
    assert_rows_equal(got.rows, want.rows, approx)
    if lite is not False:
        assert_same_rows(got.rows, conn.execute(lite or sql).fetchall())


def test_selection_copies_only_the_matched_ids(engines):
    _, port_engine, _ = engines
    res = port_engine.query("SELECT id FROM t WHERE day = 7 LIMIT 3")
    matched = port_engine.query("SELECT COUNT(*) FROM t WHERE day = 7").rows[0][0]
    assert res.stats.bytes_to_host == 8 * matched  # int64 ids, not the bool row masks


def test_window_row_cap_matches_jax(engines):
    jax_engine, port_engine, _ = engines
    sql = "SET maxWindowRows = 10; SELECT id, ROW_NUMBER() OVER (ORDER BY id) FROM t LIMIT 5"
    for eng in (jax_engine, port_engine):
        with pytest.raises(ValueError, match="maxWindowRows"):
            eng.query(sql)


def test_windows_outside_selection_are_refused_as_in_jax(engines):
    jax_engine, port_engine, _ = engines
    sql = "SELECT city, COUNT(*), ROW_NUMBER() OVER (ORDER BY city) FROM t GROUP BY city"
    for eng in (jax_engine, port_engine):
        with pytest.raises(NotImplementedError, match="window functions apply to selection queries only"):
            eng.query(sql)


# -- the distributed engine ---------------------------------------------------
DIST_SELECTIONS = [
    "SELECT d, q, disc, rev FROM t WHERE q = 1 AND disc = 0 ORDER BY rev DESC, d LIMIT 20",
    "SELECT d, q, city FROM t WHERE q < 4 LIMIT 5000",  # every matched row, in doc order
    "SELECT * FROM t WHERE yr = 2007 LIMIT 5000",
    "SELECT city, rev FROM t WHERE q > 45 ORDER BY city NULLS FIRST, rev LIMIT 30 OFFSET 4",
    "SELECT price, d FROM t WHERE disc IN (2, 3) ORDER BY price DESC NULLS LAST, d LIMIT 40",
    "SELECT rev FROM t LIMIT 7 OFFSET 3",
]


@pytest.fixture(scope="module")
def dist_engines():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINOT_TPU_SCAN_BACKEND", "interpret")
        pallas_scan.scan_backend.cache_clear()
        js, ps = _stacked_pair()
        lb = _launch_bytes_for(ps, 4)
        je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=lb)
        pe = PortDist(device="cpu", launch_bytes=lb)
        je.register_table("t", js)
        pe.register_table("t", ps)
        yield je, pe
    pallas_scan.scan_backend.cache_clear()


@pytest.mark.parametrize("sql", DIST_SELECTIONS)
def test_dist_selection_matches_jax(dist_engines, sql):
    """Several launches and a tail window that re-covers docs an earlier
    launch covered: a re-covered row counted twice would show as an extra
    row here."""
    je, pe = dist_engines
    plan = pe._plan(port_parse(sql), pe.tables["t"])
    assert plan.kind == "selection"
    assert len(plan.batch_offsets) >= 3 and plan.batch_offsets[-1][1] > 0, plan.batch_offsets
    want, got = je.query(sql), pe.query(sql)
    assert got.columns == want.columns
    assert_rows_equal(got.rows, want.rows)
    assert got.stats.bytes_to_host > 0


@pytest.mark.parametrize("sql", [
    "SELECT d, rev * disc FROM t WHERE q = 1 LIMIT 10",  # expression select item
    "SELECT d, ROW_NUMBER() OVER (ORDER BY d) FROM t LIMIT 10",  # window
    "SELECT d FROM t ORDER BY rev * 2 LIMIT 10",  # expression ORDER BY
])
def test_dist_refuses_what_jax_refuses(dist_engines, sql):
    je, pe = dist_engines
    with pytest.raises(NotImplementedError):
        je.query(sql)
    with pytest.raises(NotImplementedError):
        pe.query(sql)
