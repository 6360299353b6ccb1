"""The plain reference of the 13 SSB queries, in NumPy.

It reads the generator's raw parts (harness/ssbgen.py) and does each join
itself, by key: the denormalized table the program serves is never read.
It imports numpy and the generator only: nothing of the program, and
nothing the program built.

Each query is a spec (`QUERIES`): its select list, its predicates, its
group columns, its aggregate and its ORDER BY, as O'Neil, O'Neil and Chen
wrote them (SSB rev. 3, section 3).  `part_partials` answers a part of the
fact table with one count and one sum a group; `merge` adds the parts and
`rows` makes the result rows in ORDER BY order.  Sums are exact: each is
summed as two 24-bit limbs in float64, whose every partial sum is a whole
number below 2**53, and joined as int64.  With `dtype="float32"` every
product and sum is float32 instead: the control, which the exact limit
has to refuse.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from port_bench.harness import ssbgen

_AGGS = {
    "ext_disc": ("lo_extendedprice", "lo_discount", 1),  # lo_extendedprice * lo_discount
    "revenue": ("lo_revenue", None, 0),
    "profit": ("lo_revenue", "lo_supplycost", -1),  # lo_revenue - lo_supplycost
}
_US, _UK = "UNITED STATES", ("UNITED KI1", "UNITED KI5")
_Y92_97 = ("between", 1992, 1997)

QUERIES: Dict[str, dict] = {
    "Q1.1": {"select": ["agg"], "agg": "ext_disc", "group": [], "order": [],
             "where": [("d_year", "eq", 1993), ("lo_discount", "between", 1, 3), ("lo_quantity", "lt", 25)]},
    "Q1.2": {"select": ["agg"], "agg": "ext_disc", "group": [], "order": [],
             "where": [("d_yearmonthnum", "eq", 199401), ("lo_discount", "between", 4, 6),
                       ("lo_quantity", "between", 26, 35)]},
    "Q1.3": {"select": ["agg"], "agg": "ext_disc", "group": [], "order": [],
             "where": [("d_weeknuminyear", "eq", 6), ("d_year", "eq", 1994), ("lo_discount", "between", 5, 7),
                       ("lo_quantity", "between", 26, 35)]},
    "Q2.1": {"select": ["agg", "d_year", "p_brand1"], "agg": "revenue", "group": ["d_year", "p_brand1"],
             "order": [("d_year", 1), ("p_brand1", 1)],
             "where": [("p_category", "eq", "MFGR#12"), ("s_region", "eq", "AMERICA")]},
    "Q2.2": {"select": ["agg", "d_year", "p_brand1"], "agg": "revenue", "group": ["d_year", "p_brand1"],
             "order": [("d_year", 1), ("p_brand1", 1)],
             "where": [("p_brand1", "between", "MFGR#2221", "MFGR#2228"), ("s_region", "eq", "ASIA")]},
    "Q2.3": {"select": ["agg", "d_year", "p_brand1"], "agg": "revenue", "group": ["d_year", "p_brand1"],
             "order": [("d_year", 1), ("p_brand1", 1)],
             "where": [("p_brand1", "eq", "MFGR#2239"), ("s_region", "eq", "EUROPE")]},
    "Q3.1": {"select": ["c_nation", "s_nation", "d_year", "agg"], "agg": "revenue",
             "group": ["c_nation", "s_nation", "d_year"], "order": [("d_year", 1), ("agg", -1)],
             "where": [("c_region", "eq", "ASIA"), ("s_region", "eq", "ASIA"), ("d_year",) + _Y92_97]},
    "Q3.2": {"select": ["c_city", "s_city", "d_year", "agg"], "agg": "revenue",
             "group": ["c_city", "s_city", "d_year"], "order": [("d_year", 1), ("agg", -1)],
             "where": [("c_nation", "eq", _US), ("s_nation", "eq", _US), ("d_year",) + _Y92_97]},
    "Q3.3": {"select": ["c_city", "s_city", "d_year", "agg"], "agg": "revenue",
             "group": ["c_city", "s_city", "d_year"], "order": [("d_year", 1), ("agg", -1)],
             "where": [("c_city", "in", _UK), ("s_city", "in", _UK), ("d_year",) + _Y92_97]},
    "Q3.4": {"select": ["c_city", "s_city", "d_year", "agg"], "agg": "revenue",
             "group": ["c_city", "s_city", "d_year"], "order": [("d_year", 1), ("agg", -1)],
             "where": [("c_city", "in", _UK), ("s_city", "in", _UK), ("d_yearmonth", "eq", "Dec1997")]},
    "Q4.1": {"select": ["d_year", "c_nation", "agg"], "agg": "profit", "group": ["d_year", "c_nation"],
             "order": [("d_year", 1), ("c_nation", 1)],
             "where": [("c_region", "eq", "AMERICA"), ("s_region", "eq", "AMERICA"),
                       ("p_mfgr", "in", ("MFGR#1", "MFGR#2"))]},
    "Q4.2": {"select": ["d_year", "s_nation", "p_category", "agg"], "agg": "profit",
             "group": ["d_year", "s_nation", "p_category"],
             "order": [("d_year", 1), ("s_nation", 1), ("p_category", 1)],
             "where": [("c_region", "eq", "AMERICA"), ("s_region", "eq", "AMERICA"), ("d_year", "in", (1997, 1998)),
                       ("p_mfgr", "in", ("MFGR#1", "MFGR#2"))]},
    "Q4.3": {"select": ["d_year", "s_city", "p_brand1", "agg"], "agg": "profit",
             "group": ["d_year", "s_city", "p_brand1"],
             "order": [("d_year", 1), ("s_city", 1), ("p_brand1", 1)],
             "where": [("c_region", "eq", "AMERICA"), ("s_nation", "eq", _US), ("d_year", "in", (1997, 1998)),
                       ("p_category", "eq", "MFGR#14")]},
}

_YEARS = 7  # d_year 1992-1998


def _test(op: str, args: Sequence, v):
    if op == "eq":
        return v == args[0]
    if op == "lt":
        return v < args[0]
    if op == "between":
        return (v >= args[0]) & (v <= args[1])
    if op == "in":
        return np.isin(v, list(args[0])) if isinstance(v, np.ndarray) else v in args[0]
    raise ValueError(f"unknown predicate {op!r}")


def _mask(attrs: Dict[str, np.ndarray], where) -> np.ndarray:
    n = len(attrs["lo_revenue"])
    m = np.ones(n, dtype=bool)
    for col, op, *args in where:
        if col in ssbgen.VOCABS:  # a string predicate, tested once a vocabulary value
            ok = np.array([bool(_test(op, args, s)) for s in ssbgen.VOCABS[col]])
            m &= ok[attrs[col]]
        else:
            m &= _test(op, args, attrs[col])
    return m


def _card(col: str) -> int:
    return _YEARS if col == "d_year" else len(ssbgen.VOCABS[col])


def _code(attrs, col: str) -> np.ndarray:
    return attrs[col] - ssbgen.FIRST_YEAR if col == "d_year" else attrs[col]


def _values(attrs, agg: str, rows: np.ndarray, dtype: str) -> np.ndarray:
    a, b, how = _AGGS[agg]
    t = np.float32 if dtype == "float32" else np.int64
    x = attrs[a][rows].astype(t)
    if b is None:
        return x
    y = attrs[b][rows].astype(t)
    return x * y if how == 1 else x - y


def num_groups(spec: dict) -> int:
    g = 1
    for col in spec["group"]:
        g *= _card(col)
    return g


def part_partials(attrs: Dict[str, np.ndarray], qids: Sequence[str], dtype: str = "exact"):
    """{qid: (counts int64[G], sums[G])} for one part of the fact table."""
    out = {}
    for qid in qids:
        spec = QUERIES[qid]
        rows = np.nonzero(_mask(attrs, spec["where"]))[0]
        key = np.zeros(len(rows), dtype=np.int64)
        for col in spec["group"]:
            key = key * _card(col) + _code(attrs, col)[rows]
        g = num_groups(spec)
        vals = _values(attrs, spec["agg"], rows, dtype)
        counts = np.bincount(key, minlength=g).astype(np.int64)
        if dtype == "float32":
            sums = np.zeros(g, dtype=np.float32)
            np.add.at(sums, key, vals)
        else:
            lo = (vals & 0xFFFFFF).astype(np.float64)
            hi = (vals >> 24).astype(np.float64)  # arithmetic shift: negative profits keep their sign
            sums = (np.bincount(key, weights=hi, minlength=g).astype(np.int64) << 24) + np.bincount(
                key, weights=lo, minlength=g).astype(np.int64)
        out[qid] = (counts, sums)
    return out


def merge(parts: List[dict]) -> dict:
    out = {}
    for p in parts:
        for qid, (c, s) in p.items():
            if qid in out:
                out[qid] = (out[qid][0] + c, out[qid][1] + s)
            else:
                out[qid] = (c.copy(), s.copy())
    return out


def _decode(col: str, code: int):
    return ssbgen.FIRST_YEAR + code if col == "d_year" else ssbgen.VOCABS[col][code]


def rows(qid: str, counts: np.ndarray, sums: np.ndarray) -> List[Tuple]:
    """The query's result rows in ORDER BY order; a group is there when
    some row fell into it.  The aggregate is a Python int (exact) or a
    float (the float32 control)."""
    spec = QUERIES[qid]
    cards = [_card(c) for c in spec["group"]]
    out = []
    for g in np.nonzero(counts)[0] if spec["group"] else [0]:
        vals, rest = {}, int(g)
        for col, card in zip(reversed(spec["group"]), reversed(cards)):
            vals[col] = _decode(col, rest % card)
            rest //= card
        agg = sums[g]
        vals["agg"] = float(agg) if sums.dtype == np.float32 else int(agg)
        out.append(vals)
    for item, direction in reversed(spec["order"]):  # stable sorts, last key first
        out.sort(key=lambda r: r[item], reverse=direction < 0)
    return [tuple(r[item] for item in spec["select"]) for r in out]


def agg_index(qid: str) -> int:
    """Where the aggregate stands in the query's select list."""
    return QUERIES[qid]["select"].index("agg")


def part_task(task):
    """part_partials of one part, made from the seed (a worker's task)."""
    seed, sf, part, orders, qids, dtype = task
    return part_partials(ssbgen.attributes(_dims(seed, sf), ssbgen.fact_part(seed, sf, part, orders)), qids, dtype)


@functools.lru_cache(maxsize=1)
def _dims(seed: int, sf: int) -> ssbgen.Dims:
    return ssbgen.dims(seed, sf)


def answer(seed: int, sf: int, parts: int, orders_per_part: int, qids: Sequence[str], dtype: str = "exact"):
    """{qid: rows} over the whole fact table, in this process (the tests'
    sizes; the benchmark spreads `part_partials` over workers)."""
    d = ssbgen.dims(seed, sf)
    got = [part_partials(ssbgen.attributes(d, ssbgen.fact_part(seed, sf, i, orders_per_part)), qids, dtype)
           for i in range(parts)]
    merged = merge(got)
    return {q: rows(q, *merged[q]) for q in qids}
