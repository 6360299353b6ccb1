"""The port's star-tree index and its query path against the JAX package's.

The data and tree config of tests/test_startree.py (an SSB-like table,
split order d_year / region / category, COUNT / SUM / AVG / MIN / MAX
pairs) go through both packages' builders.  The levels must come out row
for row equal (dimension codes and integer fields exactly, float sums of
squares to rtol 1e-9).  Every query of the JAX test file runs on both
packages with the tree and with SET useStarTree=false: the four answers
must agree with each other and with sqlite, the star run must scan fewer
docs and report the startree index use where the JAX package's does, and
the level chosen must be the JAX package's.  Segments saved by either
package load into the port; a tree segment beside a plain one merges in
one key space.

Tolerance: exact for integer results; rtol 1e-9 for AVG (the tree's sums
and the scan's sums add the same integers in different orders, exactly).
"""
import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.segment.segment import ImmutableSegment as JaxSegment
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.indexes.startree import StarTreeIndex
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.segment.segment import ImmutableSegment as PortSegment
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema

from golden import assert_same_rows, sqlite_from_data
from test_torch_query import assert_rows_match

N = 8000
YEARS = list(range(1992, 1999))
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA"]
CATS = ["c%d" % i for i in range(12)]
ST_CFG = {
    "dimensionsSplitOrder": ["d_year", "region", "category"],
    "functionColumnPairs": ["COUNT__*", "SUM__revenue", "AVG__quantity", "MIN__revenue", "MAX__revenue"],
    "maxLeafRecords": 10000,
}


def make_data(seed):
    rng = np.random.default_rng(seed)
    return {
        "d_year": rng.choice(YEARS, N).astype(np.int32),
        "region": rng.choice(REGIONS, N).astype(object),
        "category": rng.choice(CATS, N).astype(object),
        "revenue": rng.integers(0, 1_000_000, N),
        "quantity": rng.integers(1, 50, N).astype(np.int32),
    }


def make_schema(S):
    return S.Schema(
        "ssb",
        [
            S.FieldSpec("d_year", S.DataType.INT),
            S.FieldSpec("region", S.DataType.STRING),
            S.FieldSpec("category", S.DataType.STRING),
            S.FieldSpec("revenue", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("quantity", S.DataType.INT, role=S.FieldRole.METRIC),
        ],
    )


def make_config(C, tree=True):
    return C.TableConfig(name="ssb", indexing=C.IndexingConfig(star_tree_index_configs=[ST_CFG] if tree else []))


@pytest.fixture(scope="module")
def env():
    data = make_data(7)
    jseg = jax_build(make_schema(jax_schema), dict(data), "seg0", table_config=make_config(jax_config))
    pseg = port_build(make_schema(port_schema), dict(data), "seg0", table_config=make_config(port_config))
    je, pe = JaxEngine(), PortEngine(device="cpu")
    je.register_table(make_schema(jax_schema), make_config(jax_config))
    pe.register_table(make_schema(port_schema), make_config(port_config))
    je.add_segment("ssb", jseg)
    pe.add_segment("ssb", pseg)
    return je, pe, sqlite_from_data("ssb", data), jseg, pseg, data


def assert_levels_equal(p: StarTreeIndex, j) -> None:
    assert p.split_order == j.split_order and p.pairs == j.pairs and p.stored == j.stored
    assert sorted(p.levels) == sorted(j.levels)
    for k, jl in j.levels.items():
        pl = p.levels[k]
        assert pl.num_rows == jl.num_rows
        assert sorted(pl.dims) == sorted(jl.dims)
        for d, arr in jl.dims.items():
            np.testing.assert_array_equal(pl.dims[d], arr)
            assert pl.dims[d].dtype == arr.dtype
        assert sorted(pl.fields) == sorted(jl.fields)
        for key, arr in jl.fields.items():
            assert pl.fields[key].dtype == arr.dtype, key
            if key[1] == "sumsq":
                np.testing.assert_allclose(pl.fields[key], arr, rtol=1e-9)
            else:
                np.testing.assert_array_equal(pl.fields[key], arr)


def test_levels_match_jax_row_for_row(env):
    _, _, _, jseg, pseg, _ = env
    assert_levels_equal(pseg.indexes["startree"]["st0"], jseg.indexes["startree"]["st0"])
    st = pseg.indexes["startree"]["st0"]
    assert st.levels[3].num_rows <= len(YEARS) * len(REGIONS) * len(CATS)
    assert st.levels[0].num_rows == 1


def test_not_built_when_barely_collapsing():
    """minCollapse: a tree whose finest level holds nearly every row is not
    built, as in the JAX package (here every row is its own combo)."""
    data = make_data(3)
    data["d_year"] = np.arange(N, dtype=np.int32)
    cfg = dict(ST_CFG, dimensionsSplitOrder=["d_year"])
    for build, C, S in ((jax_build, jax_config, jax_schema), (port_build, port_config, port_schema)):
        tc = C.TableConfig(name="ssb", indexing=C.IndexingConfig(star_tree_index_configs=[cfg]))
        assert "startree" not in build(make_schema(S), dict(data), "s", table_config=tc).indexes


# (sql, star expected, approximate cells)
SQL_SET = [
    ("SELECT d_year, SUM(revenue) FROM ssb GROUP BY d_year", True, ()),
    ("SELECT d_year, SUM(revenue) FROM ssb WHERE region = 'ASIA' GROUP BY d_year", True, ()),
    ("SELECT d_year, region, COUNT(*), SUM(revenue), AVG(quantity), MIN(revenue), MAX(revenue) FROM ssb "
     "GROUP BY d_year, region LIMIT 100", True, (4,)),
    ("SELECT SUM(revenue), COUNT(*) FROM ssb", True, ()),
    ("SELECT MIN(revenue), MAX(revenue), AVG(quantity) FROM ssb WHERE category IN ('c1', 'c7')", True, (2,)),
    ("SELECT region, SUM(revenue) FROM ssb WHERE d_year > 1994 GROUP BY region", True, ()),
    ("SELECT region, SUM(revenue) AS r FROM ssb GROUP BY region HAVING r > 0 ORDER BY r DESC LIMIT 3", True, ()),
    ("SELECT d_year, COUNT(*) FROM ssb WHERE quantity > 25 GROUP BY d_year", False, ()),
    ("SELECT d_year, SUM(quantity) FROM ssb GROUP BY d_year", True, ()),
    ("SELECT d_year, MIN(quantity) FROM ssb GROUP BY d_year", False, ()),
    ("SELECT category, COUNT(*) FROM ssb GROUP BY category LIMIT 100", True, ()),
    ("SELECT d_year, SUM(revenue) FILTER (WHERE region = 'ASIA'), COUNT(*) FROM ssb GROUP BY d_year", True, ()),
    ("SELECT d_year, SUM(revenue) FROM ssb WHERE region <> 'AFRICA' AND NOT category = 'c3' GROUP BY d_year",
     True, ()),
]


@pytest.mark.parametrize("sql,star,approx", SQL_SET, ids=[q[0][:70] for q in SQL_SET])
def test_star_and_scan_match_jax_and_sqlite(env, sql, star, approx):
    je, pe, conn, _, _, _ = env
    got, got_scan = pe.query(sql), pe.query("SET useStarTree=false; " + sql)
    want = je.query(sql)
    assert_rows_match(got.rows, want.rows, approx)
    assert_rows_match(got_scan.rows, je.query("SET useStarTree=false; " + sql).rows, approx)
    lite = sql.replace("SUM(revenue) FILTER (WHERE region = 'ASIA')", "SUM(CASE WHEN region = 'ASIA' THEN revenue END)")
    assert_same_rows(got.rows, conn.execute(lite).fetchall())
    assert_same_rows(got_scan.rows, conn.execute(lite).fetchall())
    kinds = {k for _, k in got.stats.filter_index_uses}
    assert ("startree" in kinds) == star
    assert got.stats.filter_index_uses == want.stats.filter_index_uses
    assert got.stats.num_docs_scanned == want.stats.num_docs_scanned
    if star:
        assert got.stats.num_docs_scanned < got_scan.stats.num_docs_scanned


def test_level_selection(env):
    _, pe, _, _, pseg, _ = env
    st = pseg.indexes["startree"]["st0"]
    assert pe.query("SELECT d_year, COUNT(*) FROM ssb GROUP BY d_year").stats.num_docs_scanned == st.levels[1].num_rows
    assert pe.query("SELECT SUM(revenue) FROM ssb").stats.num_docs_scanned == 1
    res = pe.query("SELECT category, COUNT(*) FROM ssb GROUP BY category")
    assert res.stats.num_docs_scanned == st.levels[3].num_rows


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_tree_loads_into_the_port(env, tmp_path, writer):
    je, _, conn, jseg, pseg, _ = env
    path = str(tmp_path / "seg_star")
    (jseg if writer == "jax" else pseg).save(path)
    seg = PortSegment.load(path, verify=True)
    assert_levels_equal(seg.indexes["startree"]["st0"], JaxSegment.load(path).indexes["startree"]["st0"])
    pe = PortEngine(device="cpu")
    pe.register_table(make_schema(port_schema), make_config(port_config, tree=False))
    pe.add_segment("ssb", seg)
    sql = "SELECT d_year, region, SUM(revenue) FROM ssb GROUP BY d_year, region LIMIT 100"
    res = pe.query(sql)
    assert_same_rows(res.rows, conn.execute(sql).fetchall())
    assert_rows_match(res.rows, je.query(sql).rows)
    assert "startree" in {k for _, k in res.stats.filter_index_uses}


def test_mixed_segments_merge(env):
    """A segment with a tree beside one without merges in one key space."""
    je, _, _, jseg, pseg, data = env
    data2 = make_data(8)
    pe = PortEngine(device="cpu")
    pe.register_table(make_schema(port_schema), make_config(port_config, tree=False))
    pe.add_segment("ssb", pseg)
    pe.add_segment("ssb", port_build(make_schema(port_schema), dict(data2), "seg1"))
    conn = sqlite_from_data("ssb", {k: np.concatenate([np.asarray(data[k]), np.asarray(data2[k])]) for k in data})
    sql = "SELECT d_year, SUM(revenue), COUNT(*) FROM ssb WHERE region != 'AFRICA' GROUP BY d_year"
    res = pe.query(sql)
    assert_same_rows(res.rows, conn.execute(sql).fetchall())
    assert "startree" in {k for _, k in res.stats.filter_index_uses}


def test_level_tables_are_a_segment_cache_entry(monkeypatch):
    """A star level's tables, with its dimensions' dictionary values, are
    one entry of the segment's device cache: staged once for repeated
    queries, charged to a residency budget in the segment's group, and
    dropped when the segment is evicted or released."""
    from pinot_tpu_torch.cluster.admission import ResourceBudget
    from pinot_tpu_torch.segment.residency import ResidencyManager
    from pinot_tpu_torch.segment.segment import star_entry

    seg = port_build(make_schema(port_schema), dict(make_data(9)), "seg9", table_config=make_config(port_config))
    pe = PortEngine(device="cpu")
    pe.register_table(make_schema(port_schema), make_config(port_config))
    pe.add_segment("ssb", seg)
    staged = []
    stage = PortSegment._stage_entry
    monkeypatch.setattr(PortSegment, "_stage_entry", staticmethod(lambda c, up, dev: staged.append(c) or stage(c, up, dev)))
    sql = "SELECT d_year, SUM(revenue) FROM ssb WHERE d_year > 1993 GROUP BY d_year"
    first, second = pe.query(sql), pe.query(sql)
    assert first.rows == second.rows and "startree" in {k for _, k in second.stats.filter_index_uses}
    assert len(staged) == 1  # the level once, the dictionary with it
    name = star_entry("st0", 1)
    lvl = seg.indexes["startree"]["st0"].levels[1]
    entry = seg._device_cache["cpu"][name]
    np.testing.assert_array_equal(entry["d_year"].numpy(), lvl.dims["d_year"])
    np.testing.assert_array_equal(entry[("d_year", "dict")].numpy(), seg.column("d_year").dictionary.device_values())
    seg.release_device()
    assert not seg._device_cache

    res = ResidencyManager(ResourceBudget(1 << 20), name="startree.level_entry")
    seg.to_device("cpu", columns=[name], residency=res)
    assert res.resident_bytes == sum(a.nbytes for a in lvl.host_arrays(seg).values()) > 0
    assert res.evict(seg.device_group("cpu"))
    assert name not in seg._device_cache.get("cpu", {})


def test_scatter_combine_matches_jax():
    import torch
    from pinot_tpu.indexes.startree import scatter_combine as jax_combine
    from pinot_tpu_torch.indexes.startree import scatter_combine as port_combine

    rng = np.random.default_rng(0)
    inv = rng.integers(0, 17, 500)
    for kind, vals in (("count", rng.integers(0, 3, 500)), ("sum", rng.integers(-9, 9, 500)),
                       ("sum", rng.random(500)), ("sumsq", rng.random(500)), ("min", rng.random(500)),
                       ("max", rng.integers(0, 99, 500))):
        got = port_combine(kind, torch.from_numpy(inv), torch.from_numpy(vals), 19).numpy()
        want = jax_combine(kind, inv, vals, 19)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-12)
