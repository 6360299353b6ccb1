"""The port's public API beside the JAX package's, on the CPU.

Each name tests/test_torch_surface.py requires of the port runs here through
both packages on the same seeded data (the port with device="cpu"), and the
answers compare EXACTLY: rows by value and Python type (assert_rows_match),
dicts, arrays and bytes by equality.

- user scalar functions: tests/test_transforms.py's TestFunctionRegistry
  scenarios, the JAX UDF in jnp and the port's in torch, rows equal and equal
  to sqlite's; a registered device function reaching the fused scan as an
  entry; list_functions;
- Schema.to_json / from_json across the packages, and the column lists;
- create-segment from a schema file Schema.to_json wrote, then query,
  through both CLIs;
- indexes/bitmap.py's masks, utils/bitmaps.py's words and cardinality,
  Dictionary.encode / insertion_index_of / code_dtype,
  StackedColumn.cardinality, the aggregations' final_dtype, audit_filter,
  KernelCost.to_dict, peak_hbm_bytes_per_sec's override, the index
  .device() copies;
- ResultTable.to_dict, ExecutionStats.merge, execute_segment,
  DistributedEngine.device_batches;
- register_index with a custom kind a port-written segment persists;
- plan_segment without a device (CUDA, raising here) and three plan-level
  scenarios of the JAX tests (test_index_filters.py, test_sparse_groupby.py).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from pinot_tpu import indexes as jax_indexes
from pinot_tpu.indexes import bitmap as jax_bitmap
from pinot_tpu.indexes.inverted import InvertedIndex as JaxInverted
from pinot_tpu.parallel import mesh as jax_mesh
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.query import executor as jax_executor
from pinot_tpu.query import functions as jax_functions
from pinot_tpu.query import planner as jax_planner
from pinot_tpu.query import reduce as jax_reduce
from pinot_tpu.query import scalar as jax_scalar
from pinot_tpu.query import shape as jax_shape
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.query.result import ExecutionStats as JaxStats
from pinot_tpu.segment import dictionary as jax_dictionary
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.segment.segment import ImmutableSegment as JaxSegment
from pinot_tpu.spi import config as jax_config
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.sql.parser import parse_query as jax_parse
from pinot_tpu.utils import bitmaps as jax_bitmaps
from pinot_tpu.utils import perf as jax_perf

import pinot_tpu_torch.query  # noqa: F401  (loads the port's aggregation registry)
from pinot_tpu_torch import indexes as port_indexes
from pinot_tpu_torch.indexes import bitmap as port_bitmap
from pinot_tpu_torch.indexes.inverted import InvertedIndex as PortInverted, RangeEncodedIndex as PortRange
from pinot_tpu_torch.ops import fused_scan
from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.query import executor as port_executor
from pinot_tpu_torch.query import functions as port_functions
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.query import reduce as port_reduce
from pinot_tpu_torch.query import scalar as port_scalar
from pinot_tpu_torch.query import shape as port_shape
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.query.result import ExecutionStats as PortStats
from pinot_tpu_torch.segment import dictionary as port_dictionary
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.segment.segment import ImmutableSegment as PortSegment
from pinot_tpu_torch.spi import config as port_config
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import parse_query as port_parse
from pinot_tpu_torch.utils import bitmaps as port_bitmaps
from pinot_tpu_torch.utils import perf as port_perf

from golden import assert_same_rows, sqlite_from_data
from test_torch_cli import run_cli
from test_torch_dist_engine import _launch_bytes_for, _stacked_pair
from test_torch_query import assert_rows_match
from test_torch_rest import both

PKGS = {"jax": (jax_schema, jax_config, jax_build, JaxEngine),
        "port": (port_schema, port_config, port_build, lambda: PortEngine(device="cpu"))}


# ---------------------------------------------------------------------------
# user scalar functions (tests/test_transforms.py TestFunctionRegistry)
# ---------------------------------------------------------------------------
EV_N = 4000
EV_NAMES = ["Alice Smith", "bob jones", "  pad  ", "Carol", "dave", "Eve Adams"]


def _ev_schema(S):
    return S.Schema("ev", [
        S.FieldSpec("name", S.DataType.STRING),
        S.FieldSpec("city", S.DataType.STRING),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
        S.FieldSpec("price", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
    ])


@pytest.fixture(scope="module")
def ev():
    """(data, {"jax" | "port": engine}, sqlite) over test_transforms.py's
    event table (one segment a package)."""
    rng = np.random.default_rng(23)
    data = {
        "name": rng.choice(EV_NAMES, EV_N).astype(object),
        "city": rng.choice(["sf", "NY", "tokyo"], EV_N).astype(object),
        "v": rng.integers(0, 1000, EV_N),
        "price": np.round(rng.random(EV_N) * 100, 3),
    }
    engines = {}
    for name, (S, _C, build, make) in PKGS.items():
        e = make()
        e.register_table(_ev_schema(S))
        e.add_segment("ev", build(_ev_schema(S), dict(data), "s0"))
        engines[name] = e
    return data, engines, sqlite_from_data("ev", data)


@pytest.fixture
def registered():
    """Registers UDFs in both packages for one test and takes them out after
    (the registries are process-global)."""
    names = []

    def add(name, jax_fn, port_fn, dict_fn=False, string_result_fn=False):
        for scalar, fn in ((jax_scalar, jax_fn), (port_scalar, port_fn)):
            if dict_fn:
                scalar.register_dict_function(name, fn, string_result_fn=string_result_fn)
            else:
                scalar.register_device_function(name, fn)
        names.append(name.lower())

    yield add
    for scalar in (jax_scalar, port_scalar):
        for n in names:
            scalar.DEVICE_FNS.pop(n, None)
            scalar.DICT_FNS.pop(n, None)
            scalar._EXTRA_STRING_RESULT.discard(n)
    port_planner.plan_cache_clear()


def _initials(values):
    return np.array(["".join(w[0] for w in str(v).split()) for v in values], dtype=object)


def test_register_device_function(ev, registered):
    data, engines, conn = ev
    registered("Clamp100", lambda v: jnp.minimum(v, 100), lambda v: torch.clamp(v, max=100))
    sql = "SELECT SUM(CLAMP100(v)) FROM ev WHERE v > 90"
    got, want = (engines[p].query(sql).rows for p in ("port", "jax"))
    assert_rows_match(got, want)
    assert_same_rows(got, conn.execute("SELECT SUM(MIN(v, 100)) FROM ev WHERE v > 90").fetchall())
    # the name is lower-cased: the registry holds "clamp100"
    assert "clamp100" in port_scalar.DEVICE_FNS and "Clamp100" not in port_scalar.DEVICE_FNS


def test_register_device_function_in_a_group_by(ev, registered):
    data, engines, conn = ev
    registered("clamp500", lambda v: jnp.clip(v, 100, 500), lambda v: torch.clamp(v, 100, 500))
    sql = "SELECT city, SUM(CLAMP500(v)), COUNT(*) FROM ev WHERE v > 50 GROUP BY city LIMIT 10"
    got, want = (engines[p].query(sql).rows for p in ("port", "jax"))
    assert_rows_match(got, want)
    lite = "SELECT city, SUM(MAX(MIN(v, 500), 100)), COUNT(*) FROM ev WHERE v > 50 GROUP BY city"
    assert_same_rows(got, conn.execute(lite).fetchall())


def test_registered_device_function_reaches_the_fused_scan(ev, registered, monkeypatch):
    """Planned for the card, SUM(UDF(v)) is an entry of the fused scan's
    launch, as a built-in expression is."""
    _, engines, _ = ev
    registered("clamp100", lambda v: jnp.minimum(v, 100), lambda v: torch.clamp(v, max=100))
    calls = []
    real = fused_scan.fused_group_tables

    def spy(entries, codes, num_groups, **kw):
        calls.append(sorted({k for k, _v, _m, _lp in entries}))
        return real(entries, codes, num_groups, **kw)

    port_planner.plan_cache_clear()
    monkeypatch.setattr(fused_scan, "fused_group_tables", spy)
    monkeypatch.setattr(port_planner, "backend_tag", lambda device: "cuda")
    sql = "SELECT city, SUM(CLAMP100(v)), COUNT(*) FROM ev GROUP BY city LIMIT 10"
    got = engines["port"].query(sql).rows
    assert calls and all(kinds[0] == "count" and len(kinds) == 2 for kinds in calls), calls
    assert_rows_match(got, engines["jax"].query(sql).rows)


def test_register_dict_function(ev, registered):
    data, engines, _ = ev
    registered("initials", _initials, _initials, dict_fn=True, string_result_fn=True)
    sel = {p: engines[p].query("SELECT name, INITIALS(name) FROM ev LIMIT 30").rows for p in ("port", "jax")}
    assert_rows_match(sel["port"], sel["jax"], ordered=True)
    for row in sel["port"]:
        assert row[1] == "".join(w[0] for w in row[0].split())
    # in a predicate (the derived-string table path) and as a group key
    expected = sum(1 for v in data["name"] if "".join(w[0] for w in v.split()) == "AS")
    for sql in ("SELECT COUNT(*) FROM ev WHERE INITIALS(name) = 'AS'",
                "SELECT INITIALS(name), COUNT(*), SUM(v) FROM ev WHERE INITIALS(name) <> 'C' "
                "GROUP BY INITIALS(name) LIMIT 10"):
        got, want = (engines[p].query(sql).rows for p in ("port", "jax"))
        assert_rows_match(got, want)
    assert engines["port"].query("SELECT COUNT(*) FROM ev WHERE INITIALS(name) = 'AS'").rows[0][0] == expected
    assert port_scalar.string_result(port_parse("SELECT INITIALS(name) FROM ev").select_list[0])


def test_list_functions(registered):
    registered("myudf", lambda v: v, lambda v: v)
    got, want = port_scalar.list_functions(), jax_scalar.list_functions()
    assert set(got) == {"device", "dictionary", "aggregation"}
    assert "datetrunc" in got["device"] and "upper" in got["dictionary"] and "percentilekll" in got["aggregation"]
    assert "myudf" in got["device"]
    assert all(got[k] == sorted(got[k]) for k in got)
    assert got == want


# ---------------------------------------------------------------------------
# schema JSON
# ---------------------------------------------------------------------------
def _rich_schema(S):
    return S.Schema("orders", [
        S.FieldSpec("id", S.DataType.LONG),
        S.FieldSpec("tags", S.DataType.STRING, single_value=False),
        S.FieldSpec("city", S.DataType.STRING, nullable=True),
        S.FieldSpec("amount", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
        S.FieldSpec("qty", S.DataType.INT, role=S.FieldRole.METRIC, nullable=True),
        S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
    ], primary_key_columns=["id"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_schema_json_across_packages(writer):
    schemas = {"jax": _rich_schema(jax_schema), "port": _rich_schema(port_schema)}
    text = schemas[writer].to_json()
    assert text == schemas["jax"].to_json() == schemas["port"].to_json()
    for S in (jax_schema, port_schema):
        loaded = S.Schema.from_json(text)
        assert loaded.to_dict() == schemas["jax"].to_dict()
    p = schemas["port"]
    assert (p.dimension_columns, p.metric_columns, p.datetime_columns) == (
        ["id", "tags", "city"], ["amount", "qty"], ["ts"])
    j = schemas["jax"]
    assert (p.dimension_columns, p.metric_columns, p.datetime_columns) == (
        j.dimension_columns, j.metric_columns, j.datetime_columns)


def test_cli_create_segment_from_to_json_and_query(tmp_path, capsys):
    """A schema file Schema.to_json wrote feeds create-segment; query
    prints the same answer through both CLIs (the JAX CLI test's shape)."""
    rng = np.random.default_rng(5)
    q = rng.integers(1, 51, 400)

    def scenario(P):
        d = tmp_path / P.name
        d.mkdir()
        schema = P.S.Schema("t", [P.S.FieldSpec("city", P.S.DataType.STRING),
                                  P.S.FieldSpec("v", P.S.DataType.LONG, role=P.S.FieldRole.METRIC),
                                  P.S.FieldSpec("q", P.S.DataType.INT)])
        (d / "schema.json").write_text(schema.to_json())
        (d / "data.csv").write_text("city,v,q\n" + "\n".join(f"c{i % 3},{i},{q[i]}" for i in range(400)))
        made = run_cli(P, capsys, ["create-segment", "--schema", str(d / "schema.json"), "--csv",
                                   str(d / "data.csv"), "--out", str(d / "seg")])
        got = [run_cli(P, capsys, ["query", "--segments", str(d / "seg"), "--sql", sql] + P.device_args)
               for sql in ("SELECT COUNT(*), SUM(v) FROM t",
                           "SELECT city, COUNT(*), SUM(v) FROM t WHERE q < 25 GROUP BY city ORDER BY city")]
        return made[0], made[1].replace(str(d), ""), got

    out = both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0 and all(rc == 0 for rc, _ in out["port"][2])
    assert str(sum(range(400))) in out["port"][2][0][1]


# ---------------------------------------------------------------------------
# bitmaps, dictionaries, stacked columns, aggregation dtypes, shape audit, perf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 4099])
def test_pack_unpack_mask(n):
    mask = np.random.default_rng(n).random(n) < 0.37
    words = port_bitmap.pack_mask(mask)
    assert words.dtype == np.uint32 and words.tobytes() == jax_bitmap.pack_mask(mask).tobytes()
    assert np.array_equal(port_bitmap.unpack_mask(words, n), jax_bitmap.unpack_mask(words, n))
    assert np.array_equal(port_bitmap.unpack_mask(words, n), mask)
    # the device pair on CPU tensors: int32 views and uint32 words alike
    for t in (torch.from_numpy(words.view(np.int32).copy()), torch.from_numpy(words.copy())):
        dev = port_bitmap.unpack_mask_device(t, n)
        assert dev.dtype == torch.bool and np.array_equal(dev.numpy(), np.asarray(jax_bitmap.unpack_mask_device(
            jnp.asarray(words), n)))
        assert int(port_bitmap.popcount_device(t)) == int(jax_bitmap.popcount_device(jnp.asarray(words)))
    assert int(port_bitmap.popcount_device(t)) == int(mask.sum())


def test_popcount_device_sign_bit_words():
    words = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 0x55555555], dtype=np.uint32)
    got = port_bitmap.popcount_device(torch.from_numpy(words.view(np.int32).copy()))
    assert int(got) == int(jax_bitmap.popcount_device(jnp.asarray(words))) == 32 + 1 + 31 + 0 + 16


def _doc_sets():
    rng = np.random.default_rng(3)
    dense = np.sort(rng.choice(1 << 17, 9000, replace=False))  # a bitmap container (> 4096 in a chunk)
    sparse = np.sort(rng.choice(200_000, 700, replace=False))
    return {"empty": np.zeros(0, np.int64), "sparse": sparse, "dense": dense,
            "mixed": np.union1d(dense, sparse + (1 << 17))}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("which", ["empty", "sparse", "dense", "mixed"])
def test_compressed_bitmap_words_and_cardinality(writer, which):
    docs = _doc_sets()[which].astype(np.uint32)
    blob = (jax_bitmaps if writer == "jax" else port_bitmaps).compress(docs)
    nwords = int(docs.max()) // 32 + 2 if len(docs) else 4
    got, want = np.zeros(nwords, np.uint32), np.zeros(nwords, np.uint32)
    assert port_bitmaps.decompress_into_words(blob, got) == jax_bitmaps.decompress_into_words(blob, want) == len(docs)
    assert np.array_equal(got, want)
    assert np.array_equal(np.flatnonzero(port_bitmap.unpack_mask(got, nwords * 32)), docs)
    assert port_bitmaps.cardinality(blob) == jax_bitmaps.cardinality(blob) == len(docs)


def test_decompress_into_words_ors_and_refuses_short_words():
    blob = port_bitmaps.compress(np.array([1, 40, 70], np.uint32))
    words = np.array([1 << 5, 0, 0], np.uint32)
    assert port_bitmaps.decompress_into_words(blob, words) == 3
    assert words.tolist() == [(1 << 5) | (1 << 1), 1 << 8, 1 << 6]
    with pytest.raises(ValueError):
        port_bitmaps.decompress_into_words(blob, np.zeros(2, np.uint32))


@pytest.mark.parametrize("kind", ["int", "double", "string"])
def test_dictionary_encode_and_insertion_index(kind):
    rng = np.random.default_rng(9)
    raw = {"int": rng.integers(-50, 50, 500), "double": np.round(rng.random(500) * 10, 2),
           "string": rng.choice(["b", "dd", "a", "zz", "c"], 500).astype(object)}[kind]
    dt = {"int": "LONG", "double": "DOUBLE", "string": "STRING"}[kind]
    jd, jcodes = jax_dictionary.Dictionary.build(getattr(jax_schema.DataType, dt), raw)
    pd, pcodes = port_dictionary.Dictionary.build(getattr(port_schema.DataType, dt), raw)
    assert np.array_equal(pd.encode(raw), jd.encode(raw)) and np.array_equal(pd.encode(raw), pcodes)
    assert pd.code_dtype == jd.code_dtype
    probes = list(raw[:20]) + ([-1000, 2.5, 1000] if kind != "string" else ["", "bb", "zzz"])
    assert [pd.insertion_index_of(v) for v in probes] == [jd.insertion_index_of(v) for v in probes]
    bad = np.asarray([raw[0], "nope" if kind == "string" else 12345], dtype=raw.dtype)
    for d in (jd, pd):
        with pytest.raises(ValueError, match="not in dictionary"):
            d.encode(bad)


def test_stacked_column_cardinality():
    js, ps = _stacked_pair()
    got = {n: c.cardinality for n, c in ps.columns.items()}
    assert got == {n: c.cardinality for n, c in js.columns.items()}
    assert got["disc"] == 11


def test_final_dtype_of_every_aggregation():
    assert set(port_functions._REGISTRY) == set(jax_functions._REGISTRY)
    got = {k: port_functions._REGISTRY[k].final_dtype() for k in sorted(port_functions._REGISTRY)}
    want = {k: jax_functions._REGISTRY[k].final_dtype() for k in sorted(jax_functions._REGISTRY)}
    assert got == want
    assert {got["count"], got["distinctcount"], got["sum"]} == {np.dtype(np.int64), np.dtype(np.float64)}


AUDIT_SQL = [
    "SELECT COUNT(*) FROM t WHERE city = 'sf' AND year > 2010",
    "SELECT COUNT(*) FROM t WHERE city IN ('sf', 'la', 'nyc') OR v BETWEEN 1 AND 9",
    "SELECT COUNT(*) FROM t WHERE REGEXP_LIKE(city, '^s') AND NOT (day < 10)",
    "SELECT COUNT(*) FROM t",
]


@pytest.mark.parametrize("sql", AUDIT_SQL)
def test_audit_filter(sql):
    def audit(parse, shape):
        return [(p.fingerprint(), ok, why) for p, ok, why in shape.audit_filter(parse(sql).filter, None)]

    assert audit(port_parse, port_shape) == audit(jax_parse, jax_shape)


def test_kernel_cost_to_dict():
    got = port_perf.KernelCost(flops=12.0, bytes_accessed=345.0).to_dict()
    want = jax_perf.KernelCost(flops=12.0, bytes_accessed=345.0).to_dict()
    assert got == {k: want[k] for k in ("flops", "bytesAccessed", "source")}


def test_peak_hbm_bytes_per_sec(monkeypatch):
    """The override wins in both packages; without one the port reads the
    card's name, and with no card the H100 SXM figure it is built for."""
    try:
        monkeypatch.setenv("PINOT_TPU_PEAK_HBM_BPS", "1e9")
        for perf in (port_perf, jax_perf):
            perf.peak_hbm_bytes_per_sec.cache_clear()
        assert port_perf.peak_hbm_bytes_per_sec() == jax_perf.peak_hbm_bytes_per_sec() == 1e9
        assert port_perf.roofline_pct(1e9, 1.0) == pytest.approx(100.0)
        monkeypatch.setenv("PINOT_TPU_PEAK_HBM_BPS", "not a number")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        port_perf.peak_hbm_bytes_per_sec.cache_clear()
        assert port_perf.peak_hbm_bytes_per_sec() == port_perf.PEAK_HBM_BYTES_PER_SEC == 3.35e12
    finally:
        monkeypatch.delenv("PINOT_TPU_PEAK_HBM_BPS", raising=False)
        for perf in (port_perf, jax_perf):
            perf.peak_hbm_bytes_per_sec.cache_clear()


def test_peak_hbm_by_card_name(monkeypatch):
    for name, want in (("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
                       ("NVIDIA H100 NVL", 3.9e12), ("NVIDIA H200", 4.8e12), ("Some Other GPU", 3.35e12)):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i, n=name: type("P", (), {"name": n}))
        port_perf.peak_hbm_bytes_per_sec.cache_clear()
        try:
            assert port_perf.peak_hbm_bytes_per_sec() == want, name
        finally:
            port_perf.peak_hbm_bytes_per_sec.cache_clear()


def test_index_device_copies(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = np.random.default_rng(4).integers(0, 7, 300)
    inv = PortInverted.build(codes, 7, 300)
    rng_idx = PortRange.build(codes, 7, 300)
    jinv = JaxInverted.build(codes, 7, 300)
    for idx, host in ((inv, inv.bitmaps), (rng_idx, rng_idx.prefix)):
        t = idx.device("cpu")
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        assert np.array_equal(t.numpy().view(np.uint32), host)
        assert idx.device("cpu") is t  # one copy a device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            idx.device()
    assert np.array_equal(inv.device("cpu").numpy().view(np.uint32), np.asarray(jinv.device()))


# ---------------------------------------------------------------------------
# results, stats, execute_segment, device_batches
# ---------------------------------------------------------------------------
def test_result_table_to_dict(ev):
    _, engines, _ = ev
    sql = "SELECT city, COUNT(*), SUM(v), MAX(price) FROM ev GROUP BY city ORDER BY city LIMIT 10"
    got, want = (engines[p].query(sql).to_dict() for p in ("port", "jax"))
    for d in (got, want):
        assert isinstance(d.pop("timeUsedMs"), float)
    assert got == want
    assert json.loads(json.dumps(got)) == got


def _stats_pair(S, seed):
    rng = np.random.default_rng(seed)
    st = S(num_segments_queried=int(rng.integers(1, 9)), num_segments_pruned=int(rng.integers(0, 3)),
           num_segments_processed=int(rng.integers(1, 9)), num_docs_scanned=int(rng.integers(0, 1000)),
           total_docs=int(rng.integers(1000, 2000)), num_groups=int(rng.integers(0, 50)))
    st.num_servers_queried, st.num_servers_responded = 3, 2 + seed % 2
    st.partial_result = bool(seed % 2)
    st.exceptions.append({"errorCode": seed})
    st.add_index_uses((("city", "inverted"),) if seed % 2 else (("year", "range"), ("city", "inverted")))
    st.query_id = None if seed % 2 else f"q{seed}"
    st.hedged, st.hedge_cancelled_ms = seed, 1.5 * seed
    st.hedge_winner = f"s{seed}" if seed % 2 else None
    st.brownout_events.append(f"enter:s{seed}")
    st.kernel_bytes, st.kernel_flops, st.kernel_cost_source = 100.0 * seed, 10.0 * seed, "analytic"
    return st


def test_execution_stats_merge():
    merged = {}
    for name, S in (("jax", JaxStats), ("port", PortStats)):
        a, b = _stats_pair(S, 2), _stats_pair(S, 3)
        a.merge(b)
        merged[name] = dataclasses.asdict(a)
    shared = set(merged["jax"]) & set(merged["port"])
    assert {"num_docs_scanned", "filter_index_uses", "hedge_winner", "kernel_bytes", "brownout_events"} <= shared
    assert {k: merged["port"][k] for k in shared} == {k: merged["jax"][k] for k in shared}


EXEC_SQL = [
    "SELECT SUM(v), COUNT(*) FROM ev WHERE city = 'sf'",
    "SELECT city, SUM(v), MAX(price) FROM ev GROUP BY city LIMIT 10",
    "SELECT name, v FROM ev WHERE v > 990 ORDER BY v, name LIMIT 20",
]


@pytest.mark.parametrize("sql", EXEC_SQL)
def test_execute_segment(ev, sql, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, engines, _ = ev
    rows = {}
    for name, parse, executor, reduce, eng in (
            ("jax", jax_parse, jax_executor, jax_reduce, engines["jax"]),
            ("port", port_parse, port_executor, port_reduce, engines["port"])):
        ctx = parse(sql)
        seg = eng.table("ev").segments[0] if name == "port" else eng.tables["ev"].segments[0]
        res, st = executor.execute_segment(ctx, seg, device="cpu") if name == "port" else \
            executor.execute_segment(ctx, seg)
        assert st.num_docs_scanned == seg.num_docs
        rows[name] = reduce.reduce_results(ctx, [res], st).rows
    assert_rows_match(rows["port"], rows["jax"], ordered="ORDER BY" in sql)
    ctx = port_parse(sql)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_executor.execute_segment(ctx, engines["port"].table("ev").segments[0])


@pytest.mark.parametrize("batches", [1, 4])
@pytest.mark.parametrize("sql", [
    "SELECT d, SUM(rev) FROM t WHERE q < 25 GROUP BY d LIMIT 2500",
    "SELECT disc, COUNT(*), SUM(rev) FROM t WHERE city = 'sf' GROUP BY disc LIMIT 20",
])
def test_device_batches(sql, batches):
    js, ps = _stacked_pair()
    lb = None if batches == 1 else _launch_bytes_for(ps, batches)
    je = JaxDist(mesh=jax_mesh.default_mesh(num_devices=1), launch_bytes=lb)
    pe = PortDist(device="cpu", launch_bytes=lb, hbm_cache_bytes=0)
    je.register_table("t", js)
    pe.register_table("t", ps)
    jplan, pplan = je._plan(jax_parse(sql), js), pe._plan(port_parse(sql), ps)
    jb, pb = je.device_batches(jplan, js), pe.device_batches(pplan, ps)
    assert len(pb) == len(jb) == len(pplan.batch_offsets) == batches

    def shapes(cols, params):
        return ({c: {k: tuple(v.shape) for k, v in e.items()} for c, e in cols.items()},
                {k: tuple(v.shape) if getattr(v, "ndim", 0) else int(v) for k, v in params.items()})

    for (jc, jp), positions in zip(jb, pb):
        assert len(positions) == 1  # one mesh position
        pc, pp = positions[0]
        assert shapes(pc, pp) == shapes(jc, jp)
        assert all(t.device.type == "cpu" for e in pc.values() for t in e.values())
        for k, v in pp.items():
            if isinstance(v, torch.Tensor):
                assert np.array_equal(v.numpy().view(np.asarray(jp[k]).dtype) if v.dtype == torch.int32
                                      and np.asarray(jp[k]).dtype == np.uint32 else v.numpy(), np.asarray(jp[k])), k


# ---------------------------------------------------------------------------
# register_index
# ---------------------------------------------------------------------------
class MinMaxIndex:
    """A user index kind: a column's min and max in one region."""

    KIND = "minmax"

    def __init__(self, bounds: np.ndarray):
        self.bounds = bounds

    def to_regions(self, prefix: str):
        yield f"{prefix}.bounds", self.bounds

    def meta(self):
        return {"kind": self.KIND, "lo": int(self.bounds[0]), "hi": int(self.bounds[1])}

    @staticmethod
    def from_regions(meta, regions, prefix: str) -> "MinMaxIndex":
        return MinMaxIndex(np.asarray(regions[f"{prefix}.bounds"]))


def test_register_index_loads_a_port_written_custom_kind(tmp_path):
    rng = np.random.default_rng(2)
    data = {"city": rng.choice(["sf", "la"], 500).astype(object), "v": rng.integers(-70, 90, 500)}
    schema = port_schema.Schema("t", [port_schema.FieldSpec("city", port_schema.DataType.STRING),
                                      port_schema.FieldSpec("v", port_schema.DataType.LONG,
                                                            role=port_schema.FieldRole.METRIC)])
    seg = port_build(schema, dict(data), "s0")
    seg.indexes["minmax"] = {"v": MinMaxIndex(np.array([data["v"].min(), data["v"].max()], np.int64))}
    seg.save(str(tmp_path / "s0"))
    try:
        for pkg_indexes, Segment in ((port_indexes, PortSegment), (jax_indexes, JaxSegment)):
            with pytest.raises(ValueError, match="unknown index kind"):
                Segment.load(str(tmp_path / "s0"))
            pkg_indexes.register_index("minmax", MinMaxIndex)
            loaded = Segment.load(str(tmp_path / "s0"), verify=True)
            idx = loaded.indexes["minmax"]["v"]
            assert isinstance(idx, MinMaxIndex) and idx.bounds.tolist() == [data["v"].min(), data["v"].max()]
        e = PortEngine(device="cpu")
        e.register_table(schema)
        e.add_segment("t", PortSegment.load(str(tmp_path / "s0")))
        assert e.query("SELECT MIN(v), MAX(v), COUNT(*) FROM t").rows == [
            (float(data["v"].min()), float(data["v"].max()), 500)]
    finally:
        port_indexes._REGISTRY.pop("minmax", None)
        jax_indexes._REGISTRY.pop("minmax", None)


# ---------------------------------------------------------------------------
# plan_segment: the device defaults to CUDA; the JAX tests' plan scenarios
# ---------------------------------------------------------------------------
IDX_N = 6000


@pytest.fixture(scope="module")
def indexed():
    """{"jax" | "port": segment} of test_index_filters.py's indexed table."""
    rng = np.random.default_rng(21)
    data = {
        "city": rng.choice(["sf", "nyc", "chi", "la", "sea", "pdx", "atx"], IDX_N).astype(object),
        "year": rng.integers(2000, 2020, IDX_N).astype(np.int32),
        "day": rng.integers(0, 366, IDX_N).astype(np.int32),
        "v": rng.integers(0, 100_000, IDX_N),
    }
    out = {}
    for name, (S, C, build, _) in PKGS.items():
        schema = S.Schema("indexed", [S.FieldSpec("city", S.DataType.STRING), S.FieldSpec("year", S.DataType.INT),
                                      S.FieldSpec("day", S.DataType.INT),
                                      S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC)])
        cfg = C.TableConfig("indexed", indexing=C.IndexingConfig(
            inverted_index_columns=["city"], range_index_columns=["year"], sorted_column="day"))
        out[name] = build(schema, dict(data), "i0", table_config=cfg)
    return out


def test_plan_segment_without_a_device_is_cuda(indexed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = port_parse("SELECT SUM(v) FROM indexed WHERE city = 'sf'")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_planner.plan_segment(ctx, indexed["port"])
    plan = port_planner.plan_segment(ctx, indexed["port"], "cpu")
    assert plan.kind == "aggregation"
    assert port_planner.plan_segment(ctx, indexed["port"], device=torch.device("cpu")).kind == "aggregation"


def test_indexed_filter_column_not_shipped(indexed):
    """An EQ predicate the inverted index answers ships the bitmap words,
    not the filter column (test_index_filters.py)."""
    plans = {"jax": jax_planner.plan_segment(jax_parse("SELECT SUM(v) FROM indexed WHERE city = 'sf'"),
                                             indexed["jax"]),
             "port": port_planner.plan_segment(port_parse("SELECT SUM(v) FROM indexed WHERE city = 'sf'"),
                                               indexed["port"], device="cpu")}
    for plan in plans.values():
        assert ("city", "inverted") in plan.index_uses
        assert "city" not in plan.needed_columns and "v" in plan.needed_columns
        bits = [v for k, v in plan.params.items() if k.endswith(".bits")]
        assert len(bits) == 1 and bits[0].dtype == np.uint32 and bits[0].shape[0] == -(-IDX_N // 32)
    assert sorted(plans["port"].needed_columns) == sorted(plans["jax"].needed_columns)
    assert plans["port"].index_uses == plans["jax"].index_uses
    pbits = [v for k, v in plans["port"].params.items() if k.endswith(".bits")][0]
    jbits = [v for k, v in plans["jax"].params.items() if k.endswith(".bits")][0]
    assert np.array_equal(pbits, jbits)


def test_sorted_range_zero_reads(indexed):
    """A sorted-column range compiles to a doc range: no column, no words
    (test_index_filters.py)."""
    sql = "SELECT COUNT(*) FROM indexed WHERE day < 50"
    jplan = jax_planner.plan_segment(jax_parse(sql), indexed["jax"])
    pplan = port_planner.plan_segment(port_parse(sql), indexed["port"], device="cpu")
    for plan in (jplan, pplan):
        assert ("day", "sorted") in plan.index_uses
        assert "day" not in plan.needed_columns
        assert all(np.asarray(v).size <= 1 for v in plan.params.values())
    assert {k: np.asarray(v).tolist() for k, v in pplan.params.items()} == {
        k: np.asarray(v).tolist() for k, v in jplan.params.items()}


def test_plan_kind_is_sparse():
    """1500 x 1500 keys pass maxDenseGroups: the sparse plan in both
    packages (test_sparse_groupby.py)."""
    rng = np.random.default_rng(17)
    n = 60_000
    data = {"k1": rng.integers(0, 1500, n).astype(np.int32), "k2": rng.integers(0, 1500, n).astype(np.int32),
            "v": rng.integers(-50, 5000, n), "w": np.round(rng.random(n) * 100, 3)}
    sql = "SELECT k1, k2, COUNT(*), SUM(v), MIN(v), MAX(w), AVG(w) FROM hc GROUP BY k1, k2"
    kinds = {}
    for name, (S, _C, build, _) in PKGS.items():
        schema = S.Schema("hc", [S.FieldSpec("k1", S.DataType.INT), S.FieldSpec("k2", S.DataType.INT),
                                 S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
                                 S.FieldSpec("w", S.DataType.DOUBLE, role=S.FieldRole.METRIC)])
        seg = build(schema, dict(data), "s0")
        kinds[name] = (jax_planner.plan_segment(jax_parse(sql), seg) if name == "jax"
                       else port_planner.plan_segment(port_parse(sql), seg, "cpu")).kind
    assert kinds == {"jax": "groupby_sparse", "port": "groupby_sparse"}
