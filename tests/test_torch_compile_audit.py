"""The port's plan-cache compile audit (analysis/compile_audit.py) against
the JAX package's.

In the port a "compile" is one planned closure built (a plan-cache miss).
The same query sequences (repeats, distinct literals of one shape, new
shapes) through the JAX engines and the port's (segment engine over the
same segments, distributed engine over the same stacked table on one
device, and the multi-stage join engine) must give the same
`compile.{sse,dist,mse}.compiles` / `.hits` counters and the same audit
summaries; the storm threshold warns and, strict, raises at the same
count in both.
"""
import warnings

import numpy as np
import pytest

import pinot_tpu  # noqa: F401
from pinot_tpu.analysis import compile_audit as jax_audit
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.query import planner as jax_planner
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.utils.metrics import METRICS as JAX_METRICS

from pinot_tpu_torch.analysis import compile_audit as port_audit
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.utils.metrics import METRICS as PORT_METRICS

from test_torch_dist_engine import _stacked_pair
from test_torch_query import build_engines, make_data
from torch_port_state import port_state  # noqa: F401


def _counters(metrics, cache):
    snap = metrics.snapshot()["counters"]
    return {k: snap.get(f"compile.{cache}.{k}", 0) for k in ("compiles", "hits", "storms")}


SSE_SEQ = [
    "SELECT city, SUM(v) FROM t GROUP BY city LIMIT 10",
    "SELECT city, SUM(v) FROM t GROUP BY city LIMIT 10",
    "SELECT COUNT(*) FROM t WHERE year > 2005",
    "SELECT COUNT(*) FROM t WHERE year > 2011",
    "SELECT COUNT(*) FROM t WHERE year > 2017",
    "SELECT SUM(v) FROM t",
    "SELECT city, SUM(v) FROM t GROUP BY city LIMIT 10",
]


def test_segment_engine_audit_matches():
    jax_planner.plan_cache_clear()
    port_planner.plan_cache_clear()
    jax_audit.reset_all()
    jx, port = build_engines({"t": (True, [make_data(s, 400) for s in (1, 2)])})
    for sql in SSE_SEQ:
        jx.sql(sql)
        port.sql(sql)
        assert _counters(PORT_METRICS, "sse") == _counters(JAX_METRICS, "sse")
    assert port_audit.SSE_AUDIT.summary() == jax_audit.SSE_AUDIT.summary()
    assert _counters(PORT_METRICS, "sse")["hits"] > 0


DIST_SEQ = [
    "SELECT d, SUM(rev) FROM t WHERE q < 25 GROUP BY d LIMIT 2500",
    "SELECT d, SUM(rev) FROM t WHERE q < 25 GROUP BY d LIMIT 2500",
    "SELECT d, SUM(rev) FROM t WHERE q < 30 GROUP BY d LIMIT 2500",
    "SELECT COUNT(*) FROM t WHERE yr BETWEEN 2001 AND 2005",
    "SELECT COUNT(*) FROM t WHERE yr BETWEEN 2003 AND 2009",
    "SELECT city, MAX(rev) FROM t GROUP BY city LIMIT 10",
]


def test_distributed_engine_audit_matches():
    jax_audit.reset_all()
    js, ps = _stacked_pair()
    je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1))
    pe = PortDist(device="cpu")
    je.register_table("t", js)
    pe.register_table("t", ps)
    for sql in DIST_SEQ:
        je.query(sql)
        pe.query(sql)
        assert _counters(PORT_METRICS, "dist") == _counters(JAX_METRICS, "dist")
    assert port_audit.DIST_AUDIT.summary() == jax_audit.DIST_AUDIT.summary()
    assert port_audit.DIST_AUDIT.counts() == {} or all(n == 1 for n in port_audit.DIST_AUDIT.counts().values())


def test_join_engine_audit_matches():
    jax_audit.reset_all()
    rng = np.random.default_rng(5)
    n = 512
    fact = {"k": rng.integers(0, 16, n).astype(np.int32), "m": rng.integers(0, 100, n).astype(np.int64)}
    dim = {"dk": np.arange(16, dtype=np.int32), "grp": np.asarray(["a", "b"] * 8, dtype=object)}

    def schemas(S):
        return (S.Schema("f", [S.FieldSpec("k", S.DataType.INT),
                               S.FieldSpec("m", S.DataType.LONG, role=S.FieldRole.METRIC)]),
                S.Schema("dim", [S.FieldSpec("dk", S.DataType.INT), S.FieldSpec("grp", S.DataType.STRING)]))

    je = JaxDist()
    pe = PortDist(device="cpu")
    for (name, data), js, ps in zip((("f", fact), ("dim", dim)), schemas(jax_schema), schemas(port_schema)):
        je.register_table(name, JaxStacked.build(js, dict(data), je.num_devices))
        pe.register_table(name, PortStacked.build(ps, dict(data), 8))
    seq = [
        "SELECT grp, SUM(m) FROM f JOIN dim ON k = dk GROUP BY grp",
        "SELECT grp, SUM(m) FROM f JOIN dim ON k = dk GROUP BY grp",
        "SELECT grp, SUM(m) FROM f JOIN dim ON k = dk WHERE m > 10 GROUP BY grp",
        "SELECT grp, SUM(m) FROM f JOIN dim ON k = dk WHERE m > 50 GROUP BY grp",
        "SELECT COUNT(*) FROM f JOIN dim ON k = dk WHERE grp = 'a'",
    ]
    for sql in seq:
        assert sorted(pe.query(sql).rows) == sorted(je.query(sql).rows)
        assert _counters(PORT_METRICS, "mse") == _counters(JAX_METRICS, "mse")
    assert _counters(PORT_METRICS, "mse")["compiles"] >= 2 and _counters(PORT_METRICS, "mse")["hits"] >= 2


@pytest.mark.parametrize("threshold,records", [(3, 4), (1, 3), (5, 5)])
def test_storm_threshold_matches(threshold, records):
    out = []
    for mod, metrics in ((jax_audit, JAX_METRICS), (port_audit, PORT_METRICS)):
        audit = mod.CompileAudit(f"storm{threshold}", threshold=threshold, strict=False)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(records):
                audit.record_compile("fp")
            audit.record_hit("fp")
        storms = [str(x.message) for x in w if "recompilation storm" in str(x.message)]
        out.append((storms, audit.summary(), _counters(metrics, f"storm{threshold}")))
        strict = mod.CompileAudit(f"strict{threshold}", threshold=threshold, strict=True)
        for _ in range(threshold):
            strict.record_compile("fp")
        with pytest.raises(mod.RecompilationStormError):
            strict.record_compile("fp")
    assert out[0] == out[1]


def test_env_knobs_read_the_same(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_RECOMPILE_LIMIT", "2")
    monkeypatch.setenv("PINOT_TPU_RECOMPILE_STRICT", "1")
    for mod in (jax_audit, port_audit):
        a = mod.CompileAudit("envknob")
        assert (a.threshold, a.strict) == (2, True)
        a.record_compile("x")
        a.record_compile("x")
        with pytest.raises(mod.RecompilationStormError):
            a.record_compile("x")
        a.reset()
        assert a.counts() == {} and a.summary()["compiles_total"] == 0
