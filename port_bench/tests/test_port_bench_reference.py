"""The plain reference against sqlite3, which runs the flat query set's
SQL text on the same tiny data."""
import sqlite3

import numpy as np
import pytest

from _tiny import SEED, TINY
from port_bench.harness import cell as cellmod, ssbgen
from port_bench.reference import ssb_numpy as ref

FLAT = cellmod.read_queries("ssb_flat")


@pytest.fixture(scope="module")
def flat_db():
    cfg = cellmod.load("ssb_flat_sf10.power_c1").config
    names = cfg["columns"]
    cols = [*names["string"], *names["dimension"], *names["metric"]]
    sf, orders = TINY["scale_factor"], TINY["orders_per_part"]
    d = ssbgen.dims(SEED, sf)
    t = ssbgen.texts(SEED, sf, d)
    db = sqlite3.connect(":memory:")
    db.execute(f"CREATE TABLE {cfg['table']} ({', '.join(cols)})")
    for part in range(TINY["parts"]):
        f = ssbgen.fact_part(SEED, sf, part, orders)
        data = ssbgen.flat_columns(d, t, f, ssbgen.fact_more(SEED, part, orders, f), cols)
        rows = zip(*[data[c].tolist() for c in cols])
        db.executemany(f"INSERT INTO {cfg['table']} VALUES ({', '.join('?' * len(cols))})", rows)
    yield db
    db.close()


@pytest.fixture(scope="module")
def reference():
    return ref.answer(SEED, TINY["scale_factor"], TINY["parts"], TINY["orders_per_part"], list(ref.QUERIES))


def test_every_query_has_a_spec():
    assert list(FLAT) == list(ref.QUERIES)


@pytest.mark.parametrize("qid", list(FLAT))
def test_reference_matches_sqlite(flat_db, reference, qid):
    sql = FLAT[qid].replace("LIMIT 10000", "")
    got = [tuple(r) for r in flat_db.execute(sql).fetchall()]
    if not ref.QUERIES[qid]["group"] and got == [(None,)]:
        got = []  # SQL's SUM over no rows
    want = reference[qid]
    if not ref.QUERIES[qid]["group"] and want == [(0,)] and not got:
        want = []
    assert got == want


def test_float32_control_differs_from_exact():
    """The control: the same reference with every product and sum in
    float32.  At the cell's sizes its sums lie above 2**24 and so round;
    at this size it must already differ somewhere, or the exact limit
    could not refuse it."""
    qids = ["Q1.1", "Q2.1", "Q4.1"]
    exact = ref.answer(SEED, 1, 2, 3000, qids)
    low = ref.answer(SEED, 1, 2, 3000, qids, dtype="float32")
    gaps = [abs(g[ref.agg_index(q)] - w[ref.agg_index(q)]) for q in qids for g, w in zip(low[q], exact[q])]
    assert max(gaps) > 0
    assert all(np.isfinite(gaps))
