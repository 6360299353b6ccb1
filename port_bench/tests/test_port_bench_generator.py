"""The generator keeps SSB's domains and cardinalities, and a seed gives
the same rows in any process."""
import json

import numpy as np
import pytest

from _tiny import REPO, SEED
from port_bench.harness import ssbgen


def test_sizes():
    n = ssbgen.sizes(20)
    assert n == {"customer": 600_000, "supplier": 40_000, "part": 1_000_000, "date": 2556, "orders": 30_000_000}
    n = ssbgen.sizes(10)
    assert n == {"customer": 300_000, "supplier": 20_000, "part": 800_000, "date": 2556, "orders": 15_000_000}


def test_vocabularies():
    assert len(ssbgen.CITY_NAMES) == len(set(ssbgen.CITY_NAMES)) == 250
    assert len(ssbgen.NATION_NAMES) == 25 and len(ssbgen.REGIONS) == 5
    assert len(ssbgen.CATEGORY_NAMES) == 25 and len(set(ssbgen.BRAND_NAMES)) == 1000
    assert ssbgen.CITY_NAMES[23 * 10 + 1] == "UNITED KI1" and ssbgen.CITY_NAMES[18 * 10] == "CHINA    0"
    assert "MFGR#2221" in ssbgen.BRAND_NAMES and "MFGR#2239" in ssbgen.BRAND_NAMES
    assert ssbgen.BRAND_NAMES[0] == "MFGR#111" and ssbgen.BRAND_NAMES[-1] == "MFGR#5540"
    assert len(set(ssbgen.COLOR_NAMES)) == 92 and len(set(ssbgen.TYPE_NAMES)) == 150
    assert len(set(ssbgen.CONTAINER_NAMES)) == 40 and len(set(ssbgen.PART_NAMES)) == 92 * 92
    assert len(ssbgen.SEGMENT_NAMES) == len(ssbgen.PRIORITY_NAMES) == 5 and len(ssbgen.SHIPMODE_NAMES) == 7


def test_dates():
    d = ssbgen.dims(SEED, 1)
    assert len(d.d_datekey) == 2556
    assert d.d_datekey[0] == 19920101 and d.d_datekey[-1] == 19981230
    assert set(np.unique(d.d_year)) == set(range(1992, 1999))
    assert ssbgen.YEARMONTH_NAMES[d.d_yearmonth[-1]] == "Dec1998"
    assert d.d_weeknuminyear.min() == 1 and d.d_weeknuminyear.max() == 53
    assert np.all(d.d_yearmonthnum == d.d_datekey // 100)


def test_fact_domains():
    sf, orders = 1, 20_000
    d = ssbgen.dims(SEED, sf)
    f = ssbgen.fact_part(SEED, sf, 0, orders)
    n = ssbgen.sizes(sf)
    rows = len(f["lo_revenue"])
    assert orders <= rows <= 7 * orders and abs(rows / orders - 4.0) < 0.1
    assert f["custkey"].min() >= 1 and f["custkey"].max() <= n["customer"]
    assert f["partkey"].min() >= 1 and f["partkey"].max() <= n["part"]
    assert f["suppkey"].min() >= 1 and f["suppkey"].max() <= n["supplier"]
    assert set(np.unique(f["lo_quantity"])) == set(range(1, 51))
    assert set(np.unique(f["lo_discount"])) == set(range(0, 11))
    assert f["date"].max() < ssbgen.ORDER_DATE_SPAN
    retail = ssbgen.retail_price(f["partkey"])
    assert np.all(f["lo_extendedprice"] == f["lo_quantity"] * retail)
    assert np.all(f["lo_revenue"] == f["lo_extendedprice"].astype(np.int64) * (100 - f["lo_discount"]) // 100)
    assert np.all(f["lo_supplycost"] == 6 * retail // 10)
    a = ssbgen.attributes(d, f)
    assert set(np.unique(a["c_region"])) <= set(range(5)) and a["c_city"].max() < 250
    assert np.all(a["p_mfgr"] == a["p_category"] // 5) and np.all(a["c_nation"] == a["c_city"] // 10)


@pytest.mark.parametrize("part", [0, 3])
def test_same_seed_same_rows(part):
    a = ssbgen.fact_part(SEED, 1, part, 500)
    b = ssbgen.fact_part(SEED, 1, part, 500)
    c = ssbgen.fact_part(SEED + 1, 1, part, 500)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["partkey"], c["partkey"])


def _flat(orders=300, part=0):
    cfg = json.loads((REPO / "port_bench" / "configs" / "ssb_flat_sf10.json").read_text())
    names = [n for k in ("string", "dimension", "metric") for n in cfg["columns"][k]]
    d = ssbgen.dims(SEED, 1)
    f = ssbgen.fact_part(SEED, 1, part, orders)
    return d, f, ssbgen.flat_columns(d, ssbgen.texts(SEED, 1, d), f, ssbgen.fact_more(SEED, part, orders, f),
                                     names), names


def test_every_lineorder_flat_column():
    """ClickHouse's lineorder_flat has 38 columns; the table adds the
    date's four numbers the queries filter on."""
    _d, _f, cols, names = _flat()
    assert len(names) == len(set(names)) == 42
    lo = [n for n in names if n.startswith("lo_")]
    assert len(lo) == 17 and sum(n[0] == "c" for n in names) == 7 and sum(n[0] == "s" for n in names) == 6
    assert sum(n.startswith("p_") for n in names) == 8 and sum(n.startswith("d_") for n in names) == 4
    rows = len(cols["lo_revenue"])
    assert all(len(c) == rows for c in cols.values())


def test_flat_columns_follow_the_keys():
    d, f, cols, _n = _flat()
    cust, supp = f["custkey"], f["suppkey"]
    assert list(cols["c_name"][:3]) == [f"Customer#{k:09d}" for k in cust[:3]]
    assert list(cols["s_name"][:3]) == [f"Supplier#{k:09d}" for k in supp[:3]]
    assert all(10 <= len(a) <= 40 for a in cols["c_address"]) and all(10 <= len(a) <= 40 for a in cols["s_address"])
    nation = [ssbgen.NATION_NAMES.index(n) for n in cols["c_nation"]]
    assert [int(p.split("-")[0]) for p in cols["c_phone"]] == [n + 10 for n in nation]
    assert all(len(p) == 15 for p in cols["c_phone"])
    a, b = zip(*(n.split() for n in cols["p_name"]))
    assert list(a) == list(cols["p_color"]) and all(x != y for x, y in zip(a, b))
    assert set(cols["p_size"]) <= set(range(1, 51)) and set(cols["lo_tax"]) <= set(range(9))
    assert list(cols["lo_custkey"]) == list(cust) and list(cols["lo_orderdate"]) == list(d.d_datekey[f["date"]])


def test_orders_and_their_lines():
    _d, f, cols, _n = _flat(orders=500, part=2)
    key, line = cols["lo_orderkey"], cols["lo_linenumber"]
    assert key.min() == 2 * 500 + 1 and key.max() == 3 * 500 and np.all(np.diff(key) >= 0)
    starts = np.r_[True, key[1:] != key[:-1]]
    assert np.all(line[starts] == 1) and np.all(line[~starts] == line[np.nonzero(~starts)[0] - 1] + 1)
    assert line.max() <= 7
    total = f["lo_extendedprice"].astype(np.int64) * (100 + cols["lo_tax"]) * (100 - f["lo_discount"])
    for k in np.unique(key)[:20]:
        assert cols["lo_ordtotalprice"][key == k][0] == total[key == k].sum() // 10_000
        assert len(set(cols["lo_orderpriority"][key == k])) == 1
    days = [np.datetime64(f"{c // 10000}-{c // 100 % 100:02d}-{c % 100:02d}") for c in cols["lo_commitdate"][:50]]
    placed = [np.datetime64(f"{c // 10000}-{c // 100 % 100:02d}-{c % 100:02d}") for c in cols["lo_orderdate"][:50]]
    assert all(30 <= (x - o).astype(int) <= 90 for x, o in zip(days, placed))
