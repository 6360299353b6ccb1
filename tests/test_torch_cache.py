"""The port's utils/cache.py LruCache and its named plan caches against the
JAX package's.

The same sequences of put / get / invalidate / clock steps go through both
packages' LruCache (a fake clock for the TTL): hits, misses and evictions
(the `{name}.*` counters of each package's METRICS), entries and bytes must
be identical after every step.  `estimate_size` must give the JAX
package's estimate on Python and numpy objects and numel * element_size on
a tensor.  The three plan caches of the port are the named LruCaches
compile.sse / compile.dist / compile.mse, bounded by
PINOT_TPU_PLAN_CACHE_ENTRIES, and the distributed and MSE ones charge
process_host_budget(), as in the JAX package.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401
from pinot_tpu.utils import cache as jax_cache
from pinot_tpu.utils.metrics import METRICS as JAX_METRICS

from pinot_tpu_torch.cluster.admission import process_host_budget
from pinot_tpu_torch.mse.engine import MultiStageEngine
from pinot_tpu_torch.parallel.engine import DistributedEngine
from pinot_tpu_torch.query import planner
from pinot_tpu_torch.sql.parser import parse_query
from pinot_tpu_torch.utils import cache as port_cache
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS

from test_torch_dist_engine import _stacked_pair
from test_torch_query import build_engines, make_data
from torch_port_state import port_state  # noqa: F401


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pair(**kw):
    caches = []
    for mod in (jax_cache, port_cache):
        c = mod.LruCache(**kw)
        c.clock = FakeClock()
        caches.append(c)
    return caches


def _counts(metrics, name):
    snap = metrics.snapshot()["counters"]
    return tuple(snap.get(f"{name}.{e}", 0) for e in ("hits", "misses", "evictions"))


VALUES = [
    "x", 7, 2.5, None, [1, 2, 3], {"a": 1, "b": [1, 2]}, tuple(range(40)), list(range(100)),
    {i: str(i) for i in range(50)}, np.arange(100, dtype=np.int64), np.zeros((7, 3), np.float32),
    frozenset({1, 2, 3}), "y" * 300,
]


def _ops(seed, n=300, keys=12):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        op = rng.choice(["put", "put", "get", "get", "get", "inv", "tick"])
        k = int(rng.integers(0, keys))
        if op == "put":
            yield ("put", k, int(rng.integers(0, len(VALUES))))
        elif op == "tick":
            yield ("tick", float(rng.choice([0.5, 3.0, 11.0])), None)
        else:
            yield (op, k, None)


@pytest.mark.parametrize("kw", [
    dict(max_entries=5),
    dict(max_bytes=4000),
    dict(max_entries=6, max_bytes=3000, ttl_s=10.0),
    dict(max_entries=8, ttl_s=4.0),
], ids=["entries", "bytes", "entries_bytes_ttl", "entries_ttl"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_sequence_same_counters(kw, seed):
    name = f"test.cache.{seed}"
    jc, pc = _pair(name=name, **kw)
    for op, k, v in _ops(seed):
        for c in (jc, pc):
            if op == "put":
                c.put(k, VALUES[v])
            elif op == "get":
                c.get(k)
            elif op == "inv":
                c.invalidate(k)
            else:
                c.clock.t += k
        assert _counts(JAX_METRICS, name) == _counts(PORT_METRICS, name)
        assert (len(jc), jc.bytes) == (len(pc), pc.bytes)
        assert jc.stats() == pc.stats()
    assert sum(_counts(PORT_METRICS, name)) > 0


def test_invalidate_where_and_clear_match():
    jc, pc = _pair(name="test.cache.where", max_entries=50)
    for c in (jc, pc):
        for k in range(20):
            c.put(("t1" if k % 2 else "t2", k), [k] * k)
    assert jc.invalidate_where(lambda k: k[0] == "t1") == pc.invalidate_where(lambda k: k[0] == "t1")
    assert jc.stats() == pc.stats()
    jc.clear()
    pc.clear()
    assert jc.stats() == pc.stats() == {"entries": 0, "bytes": 0}


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_estimate_size_matches_jax_on_host_objects(i):
    assert port_cache.estimate_size(VALUES[i]) == jax_cache.estimate_size(VALUES[i])


def test_estimate_size_of_tensors():
    t = torch.zeros((5, 7), dtype=torch.int64)
    base = port_cache.estimate_size(object())
    assert port_cache.estimate_size(t) - port_cache.estimate_size(torch.zeros(0)) == 5 * 7 * 8
    assert port_cache.estimate_size(torch.zeros(3, dtype=torch.float32)) > base
    nested = {"a": torch.zeros(100, dtype=torch.int32), "b": [torch.zeros(10, dtype=torch.bool)]}
    assert port_cache.estimate_size(nested) >= 400 + 10


def test_budget_charge_and_eviction_match():
    from pinot_tpu.cluster.admission import ResourceBudget as JaxBudget

    from pinot_tpu_torch.cluster.admission import ResourceBudget as PortBudget

    jb, pb = JaxBudget(2000), PortBudget(2000)
    jc = jax_cache.LruCache(max_entries=100, name="test.cache.budget", budget=jb)
    pc = port_cache.LruCache(max_entries=100, name="test.cache.budget", budget=pb)
    for k in range(30):
        jc.put(k, list(range(k * 3)))
        pc.put(k, list(range(k * 3)))
        assert (jb.in_use, len(jc)) == (pb.in_use, len(pc))
    assert _counts(JAX_METRICS, "test.cache.budget") == _counts(PORT_METRICS, "test.cache.budget")
    assert PORT_METRICS.snapshot()["counters"].get("test.cache.budget.evictions", 0) > 0


SHAPES = [
    "SELECT COUNT(*) FROM t",
    "SELECT city, SUM(v) FROM t GROUP BY city LIMIT 10",
    "SELECT year, COUNT(*) FROM t WHERE day < 100 GROUP BY year LIMIT 10",
]
DIST_SHAPES = [
    "SELECT COUNT(*) FROM t",
    "SELECT city, SUM(rev) FROM t GROUP BY city LIMIT 10",
    "SELECT yr, COUNT(*) FROM t WHERE d < 19920200 GROUP BY yr LIMIT 10",
]
MSE_SHAPES = [
    "SELECT COUNT(*) FROM t JOIN dim ON t.yr = dim.dyr",
    "SELECT dim.label, SUM(t.rev) FROM t JOIN dim ON t.yr = dim.dyr GROUP BY dim.label",
    "SELECT SUM(t.rev) FROM t JOIN dim ON t.yr = dim.dyr WHERE dim.label = 'a'",
]


def _dim_table():
    from pinot_tpu_torch.parallel.stacked import StackedTable
    from pinot_tpu_torch.spi import schema as S

    schema = S.Schema("dim", [S.FieldSpec("dyr", S.DataType.INT), S.FieldSpec("label", S.DataType.STRING)])
    yrs = np.arange(2000, 2024, dtype=np.int32)
    return StackedTable.build(schema, {"dyr": yrs, "label": np.asarray(["a", "b", "c"] * 8, dtype=object)},
                              num_shards=1)


def test_plan_cache_entries_bound_all_three(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_PLAN_CACHE_ENTRIES", "2")
    assert planner._plan_cache_entries() == 2
    # the segment engine's cache is made at import from the same reader
    monkeypatch.setattr(planner._PLAN_CACHE, "max_entries", planner._plan_cache_entries())
    planner.plan_cache_clear()
    _j, sse = build_engines({"t": (True, [make_data(3, 500)])})
    for q in SHAPES:
        sse.sql(q)
    assert len(planner._PLAN_CACHE) == 2

    _js, ps = _stacked_pair()
    dist = DistributedEngine(device="cpu")
    dist.register_table("t", ps)
    dist.register_table("dim", _dim_table())
    for q in DIST_SHAPES:
        dist.query(q)
    assert dist._plan_cache.max_entries == 2 and len(dist._plan_cache) == 2
    for q in MSE_SHAPES:
        dist.query(q)
    mse = dist._mse()
    assert isinstance(mse, MultiStageEngine)
    assert mse._plan_cache.max_entries == 2 and len(mse._plan_cache) == 2
    counters = PORT_METRICS.snapshot()["counters"]
    for name in ("compile.sse", "compile.dist", "compile.mse"):
        assert counters.get(f"{name}.evictions") == 1, name
        assert counters.get(f"{name}.misses") == 3, name
    stats = port_cache.named_cache_stats()
    for name in ("compile.sse", "compile.dist", "compile.mse", "compile.batch.dist"):
        assert name in stats
    assert stats["compile.dist"]["entries"] == 2


def test_plan_caches_charge_the_process_host_budget():
    budget = process_host_budget()
    before = budget.in_use
    _js, ps = _stacked_pair()
    dist = DistributedEngine(device="cpu")
    dist.register_table("t", ps)
    dist.register_table("dim", _dim_table())
    dist.query(DIST_SHAPES[1])
    assert dist._plan_cache.budget is budget
    assert budget.in_use - before == dist._plan_cache.bytes > 0
    dist.query(MSE_SHAPES[1])
    mse = dist._mse()
    assert mse._plan_cache.budget is budget
    assert budget.in_use - before == dist._plan_cache.bytes + mse._plan_cache.bytes
    dist._plan_cache.clear()
    mse._plan_cache.clear()
    assert budget.in_use == before


def test_sse_cache_charges_an_attached_budget():
    from pinot_tpu_torch.cluster.admission import ResourceBudget

    budget = ResourceBudget(1 << 30)
    old = planner._PLAN_CACHE.budget
    try:
        planner.attach_plan_cache_budget(budget)
        assert len(planner._PLAN_CACHE) == 0
        _j, sse = build_engines({"t": (True, [make_data(4, 300)])})
        sse.sql(SHAPES[1])
        assert budget.in_use == planner._PLAN_CACHE.bytes > 0
        planner.attach_plan_cache_budget(budget)  # idempotent: the cache stays warm
        assert len(planner._PLAN_CACHE) == 1
    finally:
        planner._PLAN_CACHE.clear()
        planner._PLAN_CACHE.budget = old
