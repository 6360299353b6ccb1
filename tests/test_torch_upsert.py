"""Upsert and dedup of the port against the JAX package's.

The scenarios of tests/test_upsert.py and the upsert cases of
tests/test_realtime_parity.py (FULL, PARTIAL with every strategy, dedup,
metadataTTL, the delete-record column, the restart bootstrap, a sorted
sealed segment, the stacked compaction) run in both packages on the same
rows from a numpy seed (test_torch_realtime.run_both); integer cells are
held exactly and float cells to rtol 1e-9, and the port also against the
sqlite golden of the latest row per key, as the JAX tests are.

Two tests hold the port's own handling of validDocIds with no realtime
manager in the way: a mask cleared in place after a warm query is honoured
by the next query on the same engine (the segment planner ANDs the mask
into every plan kind as a per-query param, never a cached device copy),
and StackedTable.from_segments drops the rows a mask clears.
"""
import numpy as np
import pytest

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.parallel.engine import DistributedEngine as JaxDist
from pinot_tpu.parallel.stacked import StackedTable as JaxStacked
from pinot_tpu.segment.builder import build_segment as jax_build

from pinot_tpu_torch.parallel.engine import DistributedEngine as PortDist
from pinot_tpu_torch.parallel.stacked import StackedTable as PortStacked
from pinot_tpu_torch.query import planner as port_planner
from pinot_tpu_torch.segment.builder import build_segment as port_build

from test_torch_realtime import assert_parity, attach, run_both, sqlite_rows
from test_torch_sketches import assert_same_rows


def orders_schema(P):
    S = P.S
    return S.Schema(
        name="orders",
        fields=[
            S.FieldSpec("order_id", S.DataType.STRING),
            S.FieldSpec("status", S.DataType.STRING),
            S.FieldSpec("amount", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
            S.FieldSpec("updated_at", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
        ],
        primary_key_columns=["order_id"],
    )


def orders_config(P, max_rows=30, sorted_column=None, dedup=False):
    C = P.C
    cfg = C.TableConfig(
        name="orders",
        indexing=C.IndexingConfig(sorted_column=sorted_column),
        segments=C.SegmentsConfig(time_column="updated_at"),
        stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=max_rows),
    )
    if dedup:
        cfg.dedup = C.DedupConfig(enabled=True)
    else:
        cfg.upsert = C.UpsertConfig(mode="FULL", comparison_column="updated_at")
    return cfg


def updates(n_keys=20, n_updates=80, seed=3):
    """Rows repeatedly updating a small key space, updated_at increasing."""
    rng = np.random.default_rng(seed)
    return [{"order_id": f"ord{int(rng.integers(0, n_keys))}",
             "status": ["open", "paid", "shipped"][int(rng.integers(0, 3))],
             "amount": float(np.round(rng.uniform(1, 100), 2)),
             "updated_at": 1_700_000_000_000 + i} for i in range(n_updates)]


def latest_per_key(rows):
    latest = {}
    for r in rows:
        cur = latest.get(r["order_id"])
        if cur is None or r["updated_at"] >= cur["updated_at"]:
            latest[r["order_id"]] = r
    return list(latest.values())


QUERIES = {
    "count_sum": "SELECT COUNT(*), SUM(amount) FROM orders",
    "by_status": "SELECT status, COUNT(*), SUM(amount) FROM orders GROUP BY status",
    "filtered": "SELECT COUNT(*) FROM orders WHERE amount > 50",
    "selection": "SELECT order_id, status, amount FROM orders WHERE amount > 20 ORDER BY order_id LIMIT 100",
}


def _answers(eng):
    return {k: eng.query(sql).rows for k, sql in QUERIES.items()}


def _golden(rows):
    return {k: sqlite_rows(rows, sql, "orders") for k, sql in QUERIES.items()}


def _manager(P, d, cfg, n_part=1):
    stream = P.R.InMemoryStream(n_part)
    return P.R.RealtimeTableDataManager(orders_schema(P), cfg, d, stream=stream), stream


# ---------------------------------------------------------------------------
# FULL upsert
# ---------------------------------------------------------------------------
def _only_latest(P, d, max_rows, sorted_column, n_keys, n_updates, seed):
    cfg = orders_config(P, max_rows=max_rows, sorted_column=sorted_column)
    mgr, stream = _manager(P, d, cfg)
    eng = attach(P, orders_schema(P), cfg, mgr)
    stream.publish_many(updates(n_keys, n_updates, seed), partition=0)
    mgr.consume_all()
    return {"sealed": len(mgr.sealed[0]), **_answers(eng)}


@pytest.mark.parametrize("case", [(30, None, 20, 80, 3), (10, "status", 6, 25, 9), (7, "amount", 9, 50, 4)],
                         ids=["two_sealed", "sorted_segment", "sorted_by_metric"])
def test_only_latest_rows_visible(tmp_path, case):
    """Only the latest row of a key answers; with a sorted column the seal
    remaps validDocIds through the builder's sort order."""
    out = run_both(_only_latest, tmp_path, *case)
    assert out["port"]["sealed"] == case[3] // case[0]
    assert_parity(out, _golden(latest_per_key(updates(*case[2:]))))


def _across_sealed_and_consuming(P, d):
    cfg = orders_config(P, max_rows=5)
    mgr, stream = _manager(P, d, cfg)
    eng = attach(P, orders_schema(P), cfg, mgr)
    stream.publish_many([{"order_id": f"k{i}", "status": "open", "amount": 10.0, "updated_at": 1000 + i}
                         for i in range(5)], partition=0)
    mgr.consume_all()
    sealed = len(mgr.sealed[0])
    stream.publish({"order_id": "k2", "status": "paid", "amount": 99.0, "updated_at": 2000}, partition=0)
    mgr.consume_all()
    return {"sealed": sealed, "rows": eng.query(QUERIES["by_status"]).rows}


def test_upsert_across_sealed_and_consuming(tmp_path):
    out = run_both(_across_sealed_and_consuming, tmp_path)
    assert out["port"]["sealed"] == 1
    assert sorted(out["port"]["rows"]) == [("open", 4, 40.0), ("paid", 1, 99.0)]
    assert_parity(out)


def _restart_bootstrap(P, d):
    cfg = orders_config(P, max_rows=20)
    mgr, stream = _manager(P, d, cfg, n_part=2)
    rows = updates(n_keys=10, n_updates=60, seed=5)
    for r in rows:
        stream.publish(r, key=r["order_id"])
    mgr.consume_all()
    before = _answers(attach(P, orders_schema(P), cfg, mgr))
    del mgr
    mgr2 = P.R.RealtimeTableDataManager(orders_schema(P), cfg, d, stream=stream)
    masks = sorted((s.name, tuple(bool(b) for b in s.valid_docs)) for segs in mgr2.sealed.values() for s in segs)
    mgr2.consume_all()
    after = _answers(attach(P, orders_schema(P), cfg, mgr2))
    assert_same_rows(after["by_status"], before["by_status"])
    return {"bootstrap_masks": masks, "pk_map": sorted((k, v.segment, v.doc) for k, v in mgr2.upsert.pk_map.items()),
            **after}


def test_restart_bootstrap(tmp_path):
    out = run_both(_restart_bootstrap, tmp_path)
    assert_parity(out, _golden(latest_per_key(updates(10, 60, 5))))


# ---------------------------------------------------------------------------
# dedup
# ---------------------------------------------------------------------------
def _dedup(P, d):
    cfg = orders_config(P, max_rows=50, dedup=True)
    mgr, stream = _manager(P, d, cfg)
    eng = attach(P, orders_schema(P), cfg, mgr)
    stream.publish_many(updates(n_keys=15, n_updates=70, seed=11), partition=0)
    mgr.consume_all()
    return {"total": mgr.total_rows, **_answers(eng)}


def test_duplicates_dropped(tmp_path):
    out = run_both(_dedup, tmp_path)
    firsts = {}
    for r in updates(15, 70, 11):
        firsts.setdefault(r["order_id"], r)
    assert out["port"]["total"] == len(firsts)
    assert_parity(out, _golden(list(firsts.values())))


def _dedup_restart(P, d):
    cfg = orders_config(P, max_rows=10, dedup=True)
    mgr, stream = _manager(P, d, cfg)
    stream.publish_many([{"order_id": f"k{i % 8}", "status": "open", "amount": 1.0, "updated_at": i}
                         for i in range(30)], partition=0)
    mgr.consume_all()
    first = mgr.total_rows
    del mgr
    mgr2 = P.R.RealtimeTableDataManager(orders_schema(P), cfg, d, stream=stream)
    mgr2.consume_all()
    return {"first": first, "total": mgr2.total_rows, "seen": sorted(mgr2.dedup.seen)}


def test_dedup_survives_restart(tmp_path):
    out = run_both(_dedup_restart, tmp_path)
    assert out["port"]["first"] == 8 and out["port"]["total"] == 8
    assert_parity(out)


# ---------------------------------------------------------------------------
# PARTIAL upsert
# ---------------------------------------------------------------------------
def _acct(P, d, with_plan, max_rows, strategies):
    S, C = P.S, P.C
    fields = [S.FieldSpec("k", S.DataType.STRING)]
    if with_plan:
        fields.append(S.FieldSpec("plan", S.DataType.STRING))
    fields += [S.FieldSpec("clicks", S.DataType.LONG, role=S.FieldRole.METRIC),
               S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME)]
    schema = S.Schema(name="acct", fields=fields, primary_key_columns=["k"])
    cfg = C.TableConfig(name="acct", segments=C.SegmentsConfig(time_column="ts"),
                        stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=max_rows),
                        upsert=C.UpsertConfig(mode="PARTIAL", comparison_column="ts",
                                              partial_upsert_strategies=strategies))
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(schema, cfg, d, stream=stream)
    return mgr, stream, attach(P, schema, cfg, mgr)


def _partial_strategies(P, d):
    mgr, stream, eng = _acct(P, d, True, 4, {"clicks": "INCREMENT", "plan": "IGNORE"})
    stream.publish_many([
        {"k": "a", "plan": "free", "clicks": 1, "ts": 1},
        {"k": "b", "plan": "pro", "clicks": 10, "ts": 2},
        {"k": "a", "plan": "ent", "clicks": 2, "ts": 3},  # plan IGNOREd, clicks += 2
        {"k": "a", "plan": None, "clicks": 4, "ts": 4},  # clicks += 4
        {"k": "b", "plan": "ent", "clicks": 5, "ts": 5},  # clicks += 5
    ], partition=0)
    mgr.consume_all()
    return {"sum": eng.query("SELECT COUNT(*), SUM(clicks) FROM acct").rows,
            "plans": eng.query("SELECT plan, COUNT(*), SUM(clicks) FROM acct GROUP BY plan ORDER BY plan").rows}


def test_partial_strategies(tmp_path):
    out = run_both(_partial_strategies, tmp_path)
    assert out["port"]["sum"] == [(2, 22.0)]  # a: 1 + 2 + 4, b: 10 + 5
    assert {r[0] for r in out["port"]["plans"]} == {"free", "pro"}
    assert_parity(out)


def _partial_across_seal(P, d):
    mgr, stream, eng = _acct(P, d, False, 2, {"clicks": "INCREMENT"})
    stream.publish_many([{"k": "a", "clicks": 3, "ts": 1}, {"k": "b", "clicks": 1, "ts": 2}], partition=0)
    mgr.consume_all()
    sealed = len(mgr.sealed[0])
    stream.publish({"k": "a", "clicks": 10, "ts": 3}, partition=0)
    mgr.consume_all()
    return {"sealed": sealed, "sum": eng.query("SELECT SUM(clicks) FROM acct").rows,
            "by_k": eng.query("SELECT k, SUM(clicks) FROM acct GROUP BY k").rows}


def test_partial_merge_across_seal(tmp_path):
    out = run_both(_partial_across_seal, tmp_path)
    assert out["port"]["sealed"] == 1 and float(out["port"]["sum"][0][0]) == 14.0
    assert_parity(out)


def _partial_mv(P, d):
    S, C = P.S, P.C
    schema = S.Schema("carts", [
        S.FieldSpec("cid", S.DataType.STRING),
        S.FieldSpec("items", S.DataType.STRING, single_value=False),
        S.FieldSpec("seen", S.DataType.STRING, single_value=False),
        S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
    ], primary_key_columns=["cid"])
    cfg = C.TableConfig("carts", segments=C.SegmentsConfig(time_column="ts"),
                        stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=3),
                        upsert=C.UpsertConfig(mode="PARTIAL", comparison_column="ts",
                                              partial_upsert_strategies={"items": "APPEND", "seen": "UNION"}))
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(schema, cfg, d, stream=stream)
    eng = attach(P, schema, cfg, mgr)
    stream.publish({"cid": "c1", "items": ["x"], "seen": ["x"], "ts": 1}, partition=0)
    stream.publish({"cid": "c1", "items": ["y"], "seen": ["x", "z"], "ts": 2}, partition=0)
    stream.publish({"cid": "c2", "items": ["q"], "seen": [], "ts": 3}, partition=0)  # seals at 3 rows
    stream.publish({"cid": "c1", "items": ["w"], "seen": ["w", "x"], "ts": 4}, partition=0)
    mgr.consume_all()
    m = mgr.managers[0].mutable
    return {"merged": (tuple(m.value_at("items", 0)), tuple(m.value_at("seen", 0))),
            "tags": eng.query("SELECT items, COUNT(*) FROM carts GROUP BY items").rows,
            "count": eng.query("SELECT COUNT(*) FROM carts WHERE seen = 'z'").rows}


def test_partial_append_and_union(tmp_path):
    out = run_both(_partial_mv, tmp_path)
    assert out["port"]["merged"] == (("x", "y", "w"), ("x", "z", "w"))
    assert_parity(out)


# ---------------------------------------------------------------------------
# the delete-record column and metadataTTL
# ---------------------------------------------------------------------------
def _del_schema(P):
    S = P.S
    return S.Schema("orders", [
        S.FieldSpec("oid", S.DataType.STRING),
        S.FieldSpec("amount", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
        S.FieldSpec("deleted", S.DataType.BOOLEAN),
        S.FieldSpec("ts", S.DataType.TIMESTAMP, role=S.FieldRole.DATE_TIME),
    ], primary_key_columns=["oid"])


def _del_cfg(P, max_rows=1000, **up):
    C = P.C
    return C.TableConfig("orders", segments=C.SegmentsConfig(time_column="ts"),
                         stream=C.StreamConfig(stream_type="memory", max_rows_per_segment=max_rows),
                         upsert=C.UpsertConfig(mode="FULL", comparison_column="ts", **up))


def _consistent_delete(P, d, max_rows):
    cfg = _del_cfg(P, max_rows=max_rows, delete_record_column="deleted")
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(_del_schema(P), cfg, d, stream=stream)
    eng = attach(P, _del_schema(P), cfg, mgr)
    q = "SELECT COUNT(*), SUM(amount) FROM orders"
    stream.publish({"oid": "a", "amount": 10.0, "deleted": False, "ts": 1}, partition=0)
    stream.publish({"oid": "b", "amount": 20.0, "deleted": False, "ts": 2}, partition=0)
    stream.publish({"oid": "a", "amount": 0.0, "deleted": True, "ts": 3}, partition=0)
    mgr.consume_all()
    out = {"deleted": eng.query(q).rows}
    stream.publish({"oid": "a", "amount": 99.0, "deleted": False, "ts": 2}, partition=0)  # older: rejected
    mgr.consume_all()
    out["older"] = eng.query(q).rows
    stream.publish({"oid": "a", "amount": 55.0, "deleted": False, "ts": 9}, partition=0)  # newer: revives
    mgr.consume_all()
    out["revived"] = eng.query(q).rows
    del mgr  # restart: the bootstrap replays the tombstone from the sealed segments
    mgr2 = P.R.RealtimeTableDataManager(_del_schema(P), cfg, d, stream=stream)
    mgr2.consume_all()
    out["restarted"] = attach(P, _del_schema(P), cfg, mgr2).query(q).rows
    return out


@pytest.mark.parametrize("max_rows", [1000, 2], ids=["consuming", "sealed"])
def test_consistent_delete_hides_rows(tmp_path, max_rows):
    out = run_both(_consistent_delete, tmp_path, max_rows)
    assert out["port"]["deleted"] == [(1, 20.0)]
    assert out["port"]["older"][0][0] == 1
    assert out["port"]["revived"] == [(2, 75.0)] and out["port"]["restarted"] == [(2, 75.0)]
    assert_parity(out)


def _ttl(P, d):
    cfg = _del_cfg(P, metadata_ttl=100.0)
    stream = P.R.InMemoryStream(1)
    mgr = P.R.RealtimeTableDataManager(_del_schema(P), cfg, d, stream=stream)
    um = mgr.upsert
    stream.publish({"oid": "old", "amount": 1.0, "deleted": False, "ts": 10}, partition=0)
    stream.publish({"oid": "new", "amount": 2.0, "deleted": False, "ts": 500}, partition=0)
    mgr.consume_all()
    before = sorted(um.pk_map)
    um.expire_ttl_keys()
    after = sorted(um.pk_map)
    eng = attach(P, _del_schema(P), cfg, mgr)
    return {"before": before, "after": after, "count": eng.query("SELECT COUNT(*) FROM orders").rows}


def test_metadata_ttl_expires_tracking(tmp_path):
    out = run_both(_ttl, tmp_path)
    assert out["port"]["before"] == [("new",), ("old",)] and out["port"]["after"] == [("new",)]
    assert out["port"]["count"][0][0] == 2  # the expired key's row stays visible
    assert_parity(out)


# ---------------------------------------------------------------------------
# compaction at stack time
# ---------------------------------------------------------------------------
def _stacked(P, d):
    cfg = orders_config(P, max_rows=20)
    mgr, stream = _manager(P, d, cfg)
    rows = updates(n_keys=8, n_updates=70, seed=21)
    stream.publish_many(rows, partition=0)
    mgr.consume_all()
    segs = mgr.query_segments()  # 3 sealed + a consuming snapshot of 10 rows
    if P.name == "jax":
        st, eng = JaxStacked.from_segments(segs, num_shards=8), JaxDist()
    else:
        st, eng = PortStacked.from_segments(segs, num_shards=8), PortDist(device="cpu")
    eng.register_table("orders", st)
    return {"segments": len(segs), "stacked_docs": st.num_docs,
            "count_sum": eng.query(QUERIES["count_sum"]).rows, "by_status": eng.query(QUERIES["by_status"]).rows}


def test_from_segments_drops_invalidated_rows(tmp_path):
    out = run_both(_stacked, tmp_path)
    latest = latest_per_key(updates(8, 70, 21))
    assert out["port"]["segments"] == 4 and out["port"]["stacked_docs"] == len(latest)
    assert_parity(out, {k: sqlite_rows(latest, QUERIES[k], "orders") for k in ("count_sum", "by_status")})


# ---------------------------------------------------------------------------
# validDocIds without a realtime manager: the two repairs of the port
# ---------------------------------------------------------------------------
def _valid_table(n=512, seed=17):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 12, n).astype(np.int32), "g": rng.integers(0, 9, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int64), "x": np.round(rng.random(n) * 10, 3)}


def _valid_schema(S):
    return S.Schema("t", [
        S.FieldSpec("k", S.DataType.INT),
        S.FieldSpec("g", S.DataType.INT),
        S.FieldSpec("v", S.DataType.LONG, role=S.FieldRole.METRIC),
        S.FieldSpec("x", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
    ])


VALID_QUERIES = {
    "aggregation": "SELECT COUNT(*), SUM(v), MAX(x) FROM t WHERE k < 9",
    "dense": "SELECT g, COUNT(*), SUM(v) FROM t WHERE k < 9 GROUP BY g LIMIT 100",
    "sparse": "SET numGroupsLimit = 1000; SELECT k, g, v, COUNT(*) FROM t GROUP BY k, g, v ORDER BY v LIMIT 30",
    "selection": "SELECT k, g, v FROM t WHERE g > 2 ORDER BY v DESC, k LIMIT 25",
    "filter_agg": "SELECT g, COUNT(*) FILTER (WHERE v > 500), SUM(v) FROM t GROUP BY g",
}


def _numpy_golden(d, keep):
    m = keep & (d["k"] < 9)
    return {"count": int(m.sum()), "sum": int(d["v"][m].sum()),
            "dense": sorted((int(g), int((m & (d["g"] == g)).sum()), float(d["v"][m & (d["g"] == g)].sum()))
                            for g in np.unique(d["g"][m]))}


def test_valid_docs_cleared_after_a_warm_query_is_honoured(tmp_path):
    """A segment's validDocIds mask is the upsert manager's own array,
    cleared in place.  The second run of each query, a plan-cache hit on the
    same engine, drops the rows cleared after the first run, as the JAX
    engine does."""
    from pinot_tpu.query.engine import QueryEngine as JaxEngine
    from pinot_tpu.spi import schema as jax_schema
    from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
    from pinot_tpu_torch.spi import schema as port_schema

    d = _valid_table()
    n = len(d["k"])
    masks, engines = {}, {}
    for name, S, build, eng in (("jax", jax_schema, jax_build, JaxEngine()),
                                ("port", port_schema, port_build, PortEngine(device="cpu"))):
        schema = _valid_schema(S)
        eng.register_table(schema)
        for i in range(2):
            seg = build(schema, {c: a[i::2] for c, a in d.items()}, f"s{i}")
            masks[(name, i)] = seg.valid_docs = np.ones(seg.num_docs, dtype=bool)
            eng.add_segment("t", seg)
        engines[name] = eng
    keep = np.ones(n, dtype=bool)
    rng = np.random.default_rng(3)
    for step in range(3):
        size_before = port_planner.plan_cache_size()
        got = {name: {q: e.query(sql).rows for q, sql in VALID_QUERIES.items()} for name, e in engines.items()}
        if step:
            assert port_planner.plan_cache_size() == size_before  # every plan a cache hit
        for q in VALID_QUERIES:
            assert_same_rows(got["port"][q], got["jax"][q], ordered=q in ("sparse", "selection"))
        want = _numpy_golden(d, keep)
        assert got["port"]["aggregation"][0][:2] == (want["count"], float(want["sum"]))
        assert sorted(got["port"]["dense"]) == want["dense"]
        # clear rows in place, as the upsert manager does
        drop = rng.choice(n, 60, replace=False)
        keep[drop] = False
        for (name, i), mask in masks.items():
            mask[:] = keep[i::2]


def test_stacked_upsert_table_answers_with_latest_rows():
    """StackedTable.from_segments keeps only the rows of validDocIds, in
    every column and null mask (the JAX package's stack-time compaction)."""
    from pinot_tpu.spi import schema as jax_schema
    from pinot_tpu_torch.spi import schema as port_schema

    d = _valid_table(n=600, seed=5)
    d["x"][::7] = np.nan  # nulls in a nullable column
    n = len(d["k"])
    keep = np.random.default_rng(8).random(n) < 0.6
    out = {}
    for name, S, build, stacked, eng in (("jax", jax_schema, jax_build, JaxStacked, JaxDist()),
                                         ("port", port_schema, port_build, PortStacked, PortDist(device="cpu"))):
        schema = _valid_schema(S)
        schema.fields[3].nullable = True
        segs = []
        for i in range(3):
            seg = build(schema, {c: a[i::3] for c, a in d.items()}, f"s{i}")
            seg.valid_docs = keep[i::3].copy()
            segs.append(seg)
        st = stacked.from_segments(segs, num_shards=8)
        eng.register_table("t", st)
        out[name] = {"docs": st.num_docs, **{q: eng.query(sql).rows for q, sql in VALID_QUERIES.items()
                                             if q not in ("selection", "filter_agg")}}
    assert out["port"]["docs"] == int(keep.sum())
    want = _numpy_golden(d, keep)
    assert out["port"]["aggregation"][0][:2] == (want["count"], float(want["sum"]))
    assert sorted(out["port"]["dense"]) == want["dense"]
    for q in out["jax"]:
        if q != "docs":
            assert_same_rows(out["port"][q], out["jax"][q], ordered=q == "sparse")
