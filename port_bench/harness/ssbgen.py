"""Star Schema Benchmark data, made from a seed.

Domains and cardinalities follow O'Neil, O'Neil and Chen, "Star Schema
Benchmark", revision 3 (2009), and its dbgen:

  date      2556 days from 1992-01-01 (dbgen's 7 years less one day)
  customer  30,000 x SF rows; c_nation uniform over the 25 TPC-H nations,
            c_city the nation's first 9 letters (blank padded) and a digit
            0-9 (250 cities), c_region the nation's region (5)
  supplier  2,000 x SF rows, the same three attributes
  part      200,000 x floor(1 + log2 SF) rows; p_mfgr MFGR#1-5, p_category
            MFGR#mc (25), p_brand1 MFGR#mcb with b in 1-40 (1000), and
            P_RETAILPRICE as TPC-H makes it from the part key
  lineorder 1,500,000 x SF orders of 1-7 lines; an order's customer and
            date are drawn once for all its lines (the date uniform over
            the first 2556 - 151 days, as dbgen draws O_ORDERDATE); each
            line draws its part, supplier, quantity 1-50 and discount 0-10;
            extended price = quantity x retail price, revenue = extended
            price x (100 - discount) / 100, supply cost = 6 x retail price
            / 10, all in cents (whole numbers)

The columns no query reads come from the same sources, at their spec
types: customer and supplier names ("Customer#" and the key in 9 digits),
addresses (10-40 characters from a 64-symbol alphabet), phones (the
nation's number + 10, then 3-3-4 digits) and the customer's market segment
(5); the part's name (two of TPC-H's 92 colors), color, type (150),
size 1-50 and container (40); an order's key, priority (5) and its lines'
numbers, ship priority (0), tax 0-8, commit date (the order date + 30-90
days), ship mode (7), and the order's total price (the sum of its lines'
extended price x (100 + tax) x (100 - discount) / 10000).

Everything comes from numpy's SeedSequence of the run's seed: the
dimension tables from spawn key (0,) and their unqueried text from (0, 1),
the orders of part i of the fact table from spawn key (1, i) and their
unqueried columns from (1, i, 1).  So a part is made alone, in any process, and
the same seed gives the same rows.  Dimension attributes are kept as codes
into small vocabularies (`Dims`); `flat_columns` turns a part into the
denormalized table's columns (every column of ClickHouse's documented
lineorder_flat, and the date's four numbers the queries filter on).

This module imports numpy only: the benchmark's plain reference reads the
same parts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
# the 25 TPC-H nations, in N_NATIONKEY order, with their region
NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
)
MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
NUM_DATES = 2556
ORDER_DATE_SPAN = NUM_DATES - 151
FIRST_YEAR = 1992

# vocabularies: a string attribute is a code into one of these
CITY_NAMES = tuple(f"{name[:9]:<9}{d}" for name, _r in NATIONS for d in range(10))  # city c -> nation c // 10
NATION_NAMES = tuple(name for name, _r in NATIONS)
NATION_REGION = np.array([r for _n, r in NATIONS], dtype=np.int64)
MFGR_NAMES = tuple(f"MFGR#{m}" for m in range(1, 6))
CATEGORY_NAMES = tuple(f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6))  # category k -> mfgr k // 5
BRAND_NAMES = tuple(f"{cat}{b}" for cat in CATEGORY_NAMES for b in range(1, 41))  # brand k -> category k // 40
YEARMONTH_NAMES = tuple(f"{MONTHS[m]}{FIRST_YEAR + y}" for y in range(7) for m in range(12))
# TPC-H's 92 color words (P_NAME, P_COLOR), type syllables, containers,
# market segments, order priorities and ship modes
COLOR_NAMES = tuple("""
    almond antique aquamarine azure beige bisque black blanched blue blush brown burlywood burnished
    chartreuse chiffon chocolate coral cornflower cornsilk cream cyan dark deep dim dodger drab
    firebrick floral forest frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory
    khaki lace lavender lawn lemon light lime linen magenta maroon medium metallic midnight mint
    misty moccasin navajo navy olive orange orchid pale papaya peach peru pink plum powder puff
    purple red rose rosy royal saddle salmon sandy seashell sienna sky slate smoke snow spring steel
    tan thistle tomato turquoise violet wheat white yellow""".split())
PART_NAMES = tuple(f"{a} {b}" for a in COLOR_NAMES for b in COLOR_NAMES)  # name k -> colors k // 92, k % 92
TYPE_NAMES = tuple(f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
                   for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
                   for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINER_NAMES = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                        for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
SEGMENT_NAMES = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITY_NAMES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SHIPMODE_NAMES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
ADDRESS_SYMBOLS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789,.", dtype=np.uint8)


def sizes(sf: int) -> Dict[str, int]:
    """Rows of each table at scale factor `sf` (orders for the fact table)."""
    return {
        "customer": 30_000 * sf,
        "supplier": 2_000 * sf,
        "part": 200_000 * int(math.floor(1 + math.log2(sf))),
        "date": NUM_DATES,
        "orders": 1_500_000 * sf,
    }


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(key)))


@dataclass
class Dims:
    """The dimension tables as codes.  Index i of a key-ordered array is key
    i + 1 (customer, supplier, part) or date index i (date)."""

    c_city: np.ndarray  # int16 city code a customer
    s_city: np.ndarray  # int16 city code a supplier
    p_brand: np.ndarray  # int16 brand code a part
    d_datekey: np.ndarray  # int32 yyyymmdd a date
    d_year: np.ndarray  # int32
    d_yearmonthnum: np.ndarray  # int32 yyyymm
    d_yearmonth: np.ndarray  # int16 code into YEARMONTH_NAMES
    d_weeknuminyear: np.ndarray  # int32, 1-53


def dims(seed: int, sf: int) -> Dims:
    n = sizes(sf)
    rng = _rng(seed, 0)
    c_city = (rng.integers(0, 25, n["customer"]) * 10 + rng.integers(0, 10, n["customer"])).astype(np.int16)
    s_city = (rng.integers(0, 25, n["supplier"]) * 10 + rng.integers(0, 10, n["supplier"])).astype(np.int16)
    p_brand = rng.integers(0, len(BRAND_NAMES), n["part"]).astype(np.int16)
    days = np.datetime64(f"{FIRST_YEAR}-01-01") + np.arange(NUM_DATES)
    years = days.astype("datetime64[Y]").astype(np.int64) + 1970
    months = days.astype("datetime64[M]").astype(np.int64) % 12  # 0-11
    mdays = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    yday = (days - days.astype("datetime64[Y]")).astype(np.int64)  # 0-365
    return Dims(
        c_city=c_city,
        s_city=s_city,
        p_brand=p_brand,
        d_datekey=(years * 10000 + (months + 1) * 100 + mdays).astype(np.int32),
        d_year=years.astype(np.int32),
        d_yearmonthnum=(years * 100 + months + 1).astype(np.int32),
        d_yearmonth=((years - FIRST_YEAR) * 12 + months).astype(np.int16),
        d_weeknuminyear=(yday // 7 + 1).astype(np.int32),
    )


def retail_price(partkey: np.ndarray) -> np.ndarray:
    """TPC-H P_RETAILPRICE in cents: 90000 + (key / 10) mod 20001 + 100 x
    (key mod 1000)."""
    k = partkey.astype(np.int64)
    return 90_000 + (k // 10) % 20_001 + 100 * (k % 1000)


def fact_part(seed: int, sf: int, part: int, orders: int) -> Dict[str, np.ndarray]:
    """The lines of `orders` orders of fact part `part`: keys, the date
    index and the measures, as int32 arrays (date index int16)."""
    n = sizes(sf)
    rng = _rng(seed, 1, part)
    lines = rng.integers(1, 8, orders)
    cust = rng.integers(1, n["customer"] + 1, orders)
    date = rng.integers(0, ORDER_DATE_SPAN, orders)
    rows = int(lines.sum())
    of_row = np.repeat(np.arange(orders), lines)
    partkey = rng.integers(1, n["part"] + 1, rows)
    suppkey = rng.integers(1, n["supplier"] + 1, rows)
    qty = rng.integers(1, 51, rows)
    disc = rng.integers(0, 11, rows)
    retail = retail_price(partkey)
    ext = qty * retail
    return {
        "custkey": cust[of_row].astype(np.int32),
        "date": date[of_row].astype(np.int16),
        "partkey": partkey.astype(np.int32),
        "suppkey": suppkey.astype(np.int32),
        "lo_quantity": qty.astype(np.int32),
        "lo_discount": disc.astype(np.int32),
        "lo_extendedprice": ext.astype(np.int32),
        "lo_revenue": (ext * (100 - disc) // 100).astype(np.int32),
        "lo_supplycost": (6 * retail // 10).astype(np.int32),
    }


def attributes(d: Dims, f: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every attribute an SSB query reads, a code or a number per fact row
    (the join done by key): city, nation and region codes of customer and
    supplier, brand, category and mfgr codes of the part, the date's
    numbers and month code, and the measures."""
    cc = d.c_city[f["custkey"] - 1].astype(np.int64)
    sc = d.s_city[f["suppkey"] - 1].astype(np.int64)
    br = d.p_brand[f["partkey"] - 1].astype(np.int64)
    di = f["date"].astype(np.int64)
    return {
        "c_city": cc, "c_nation": cc // 10, "c_region": NATION_REGION[cc // 10],
        "s_city": sc, "s_nation": sc // 10, "s_region": NATION_REGION[sc // 10],
        "p_brand1": br, "p_category": br // 40, "p_mfgr": br // 200,
        "d_year": d.d_year[di], "d_yearmonthnum": d.d_yearmonthnum[di],
        "d_yearmonth": d.d_yearmonth[di].astype(np.int64), "d_weeknuminyear": d.d_weeknuminyear[di],
        "lo_quantity": f["lo_quantity"], "lo_discount": f["lo_discount"],
        "lo_extendedprice": f["lo_extendedprice"], "lo_revenue": f["lo_revenue"],
        "lo_supplycost": f["lo_supplycost"],
    }


# the vocabulary of each string attribute
VOCABS = {
    "c_city": CITY_NAMES, "c_nation": NATION_NAMES, "c_region": REGIONS,
    "s_city": CITY_NAMES, "s_nation": NATION_NAMES, "s_region": REGIONS,
    "p_brand1": BRAND_NAMES, "p_category": CATEGORY_NAMES, "p_mfgr": MFGR_NAMES,
    "d_yearmonth": YEARMONTH_NAMES,
}


@dataclass
class Texts:
    """The dimension tables' columns no query reads, one entry a customer,
    supplier or part (index i is key i + 1): str objects, or codes into a
    vocabulary."""

    c_name: np.ndarray
    c_address: np.ndarray
    c_phone: np.ndarray
    c_mktsegment: np.ndarray  # int8 code into SEGMENT_NAMES
    s_name: np.ndarray
    s_address: np.ndarray
    s_phone: np.ndarray
    p_name: np.ndarray  # int16 code into PART_NAMES
    p_color: np.ndarray  # int8 code into COLOR_NAMES
    p_type: np.ndarray  # int16 code into TYPE_NAMES
    p_size: np.ndarray  # int32, 1-50
    p_container: np.ndarray  # int8 code into CONTAINER_NAMES


def _addresses(rng: np.random.Generator, n: int) -> np.ndarray:
    """n addresses of 10-40 symbols, as str objects."""
    chars = ADDRESS_SYMBOLS[rng.integers(0, len(ADDRESS_SYMBOLS), (n, 40))]
    chars[np.arange(40) >= rng.integers(10, 41, n)[:, None]] = 0  # a bytes string ends at its first 0
    return np.ascontiguousarray(chars).view("S40").ravel().astype("U40").astype(object)


def _phones(rng: np.random.Generator, nation: np.ndarray) -> np.ndarray:
    a, b, c = rng.integers(100, 1000, len(nation)), rng.integers(100, 1000, len(nation)), rng.integers(
        1000, 10000, len(nation))
    out = np.empty(len(nation), dtype=object)
    out[:] = [f"{n + 10}-{x}-{y}-{z}" for n, x, y, z in zip(nation.tolist(), a.tolist(), b.tolist(), c.tolist())]
    return out


def _keyed(prefix: str, n: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    out[:] = [f"{prefix}#{k:09d}" for k in range(1, n + 1)]
    return out


def texts(seed: int, sf: int, d: Dims) -> Texts:
    n = sizes(sf)
    rng = _rng(seed, 0, 1)
    color1 = rng.integers(0, len(COLOR_NAMES), n["part"])
    color2 = (color1 + rng.integers(1, len(COLOR_NAMES), n["part"])) % len(COLOR_NAMES)  # two colors that differ
    return Texts(
        c_name=_keyed("Customer", n["customer"]),
        c_address=_addresses(rng, n["customer"]),
        c_phone=_phones(rng, d.c_city // 10),
        c_mktsegment=rng.integers(0, len(SEGMENT_NAMES), n["customer"]).astype(np.int8),
        s_name=_keyed("Supplier", n["supplier"]),
        s_address=_addresses(rng, n["supplier"]),
        s_phone=_phones(rng, d.s_city // 10),
        p_name=(color1 * len(COLOR_NAMES) + color2).astype(np.int16),
        p_color=color1.astype(np.int8),
        p_type=rng.integers(0, len(TYPE_NAMES), n["part"]).astype(np.int16),
        p_size=rng.integers(1, 51, n["part"]).astype(np.int32),
        p_container=rng.integers(0, len(CONTAINER_NAMES), n["part"]).astype(np.int8),
    )


def fact_more(seed: int, part: int, orders: int, f: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The lines' columns no query reads, for fact part `part` of `orders`
    orders (f = fact_part's lines): order key, line number, priority codes,
    ship priority, tax, commit date (yyyymmdd), ship-mode codes and the
    order's total price."""
    lines = _rng(seed, 1, part).integers(1, 8, orders)  # fact_part's first draw: the same lines
    of_row = np.repeat(np.arange(orders), lines)
    first = np.cumsum(lines) - lines
    rows = len(of_row)
    rng = _rng(seed, 1, part, 1)
    priority = rng.integers(0, len(PRIORITY_NAMES), orders)
    tax = rng.integers(0, 9, rows)
    commit = np.datetime64(f"{FIRST_YEAR}-01-01") + f["date"].astype(np.int64) + rng.integers(30, 91, rows)
    shipmode = rng.integers(0, len(SHIPMODE_NAMES), rows)
    years = commit.astype("datetime64[Y]")
    months = commit.astype("datetime64[M]")
    commit_key = ((years.astype(np.int64) + 1970) * 10000 + (months.astype(np.int64) % 12 + 1) * 100
                  + (commit - months).astype(np.int64) + 1)
    line_total = (f["lo_extendedprice"].astype(np.int64) * (100 + tax) * (100 - f["lo_discount"].astype(np.int64)))
    total = np.bincount(of_row, weights=line_total, minlength=orders).astype(np.int64) // 10_000
    return {
        "lo_orderkey": (part * orders + of_row + 1).astype(np.int32),
        "lo_linenumber": (np.arange(rows) - first[of_row] + 1).astype(np.int32),
        "lo_orderpriority": priority[of_row],
        "lo_shippriority": np.zeros(rows, dtype=np.int32),
        "lo_tax": tax.astype(np.int32),
        "lo_commitdate": commit_key.astype(np.int32),
        "lo_shipmode": shipmode,
        "lo_ordtotalprice": total[of_row].astype(np.int32),
    }


# the vocabulary of each column held as codes, beyond VOCABS
TEXT_VOCABS = {
    "c_mktsegment": SEGMENT_NAMES, "p_name": PART_NAMES, "p_color": COLOR_NAMES, "p_type": TYPE_NAMES,
    "p_container": CONTAINER_NAMES, "lo_orderpriority": PRIORITY_NAMES, "lo_shipmode": SHIPMODE_NAMES,
}


def _text(vocab, codes: np.ndarray) -> np.ndarray:
    """An object array of the vocabulary's own str objects, one a row."""
    v = np.empty(len(vocab), dtype=object)
    v[:] = vocab
    return v[codes]


def flat_columns(d: Dims, t: Texts, f: Dict[str, np.ndarray], more: Dict[str, np.ndarray],
                 names) -> Dict[str, np.ndarray]:
    """The denormalized table's columns `names` for one fact part (f from
    fact_part, more from fact_more): strings as str objects, numbers as
    int32."""
    attrs = attributes(d, f)
    cust, supp, part = (f[k].astype(np.int64) - 1 for k in ("custkey", "suppkey", "partkey"))
    at = {"c": cust, "s": supp, "p": part}
    out = {}
    for name in names:
        if name in VOCABS:
            out[name] = _text(VOCABS[name], attrs[name])
        elif name in attrs:
            out[name] = attrs[name].astype(np.int32)
        elif name in more:
            a = more[name]
            out[name] = _text(TEXT_VOCABS[name], a) if name in TEXT_VOCABS else a
        elif name == "lo_orderdate":
            out[name] = d.d_datekey[f["date"].astype(np.int64)]
        elif name in ("lo_custkey", "lo_partkey", "lo_suppkey"):
            out[name] = f[name[3:]]
        else:  # a customer's, supplier's or part's own column
            a = getattr(t, name)[at[name[0]]]
            out[name] = _text(TEXT_VOCABS[name], a) if name in TEXT_VOCABS else a
    return out
