"""All 13 queries on the port (device="cpu") at a tiny size against the
plain reference: the flat set through the Broker, built as the benchmark
builds it (segments in spawned workers)."""
import pytest

from _tiny import SEED, TINY, tiny
from port_bench.harness import cell as cellmod, compare
from port_bench.reference import ssb_numpy as ref

CELLS = {"flat": "ssb_flat_sf10.power_c1"}


@pytest.fixture(scope="module")
def reference():
    return ref.answer(SEED, TINY["scale_factor"], TINY["parts"], TINY["orders_per_part"], list(ref.QUERIES))


@pytest.fixture(scope="module", params=list(CELLS))
def served(request):
    c = tiny(CELLS[request.param])
    system = cellmod.module("systems", c.config["system"]).System(c.config, SEED, lambda *a, **k: None,
                                                                   device="cpu")
    yield c, system
    system.close()


@pytest.mark.parametrize("qid", list(ref.QUERIES))
def test_query_matches_reference(served, reference, qid):
    c, system = served
    got = compare.canonical(system.query(c.queries[qid]).rows)
    assert compare.compare(got, reference[qid], ref.agg_index(qid)) == (0, 0.0), (got[:3], reference[qid][:3])
