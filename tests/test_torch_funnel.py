"""The port's funnel family (FUNNELCOUNT / FUNNELCOMPLETECOUNT /
FUNNELMAXSTEP, unordered and ordered) and the ordered funnel's row scan
(ops/funnel_scan.py, whose kernel is CUDA) against the JAX package.

  * ``funnel_reach`` on CPU tensors (the plain version of the kernel's
    function: the wrapper takes ``scan_runs_reference`` there) against ``pinot_tpu.query.aggs_stats._ordered_funnel_reach`` on rows
    whose (key, ts) pairs are distinct: the JAX sort is not stable, so
    equal (key, ts) rows have no defined order there; and against the JAX
    package's own test oracle (``tests/test_funnel_ordered.py``), whose
    stable time order the port's stable sort follows, ties included.
  * The split between ``prepare`` and the scan: runs above a lowered
    ``RUN_CAP`` (ordered by ``prepare``) against the oracle with ties, one
    skewed key above the cap beside many short keys, one ``torch.sort`` in
    ``prepare`` when no run passes the cap (a spy), and ``scan_runs``'s
    operand checks.
  * The wrapper: the plain version on CPU tensors, a refusal elsewhere.
  * SQL through both packages: the events world of the JAX package's
    funnel tests (one segment, and three partitioned by key), and the
    distributed engine at one launch and at four.

Tolerances: reach tables and every presence field identical; integer
results identical.  The kernel itself runs only on the card: chip_smoke.py
holds it against the plain version there (2^20 rows at S = 3 and 4, NaN and
extreme timestamps, one segment's rows, query (n)'s shape, and skewed keys
at the kernel's tile edges).
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
import jax.numpy as jnp
from pinot_tpu.query import functions as jf  # noqa: F401  (the JAX registry first)
from pinot_tpu.query.aggs_stats import _ordered_funnel_reach
from pinot_tpu.query.engine import QueryEngine as JaxEngine
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import schema as jax_schema

from pinot_tpu_torch.ops import funnel_scan
from pinot_tpu_torch.query.engine import QueryEngine as PortEngine
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import schema as port_schema

from test_funnel_ordered import CONDS, STEPS_SQL, _oracle_reach
from test_torch_sketches import assert_same_rows, dist_engines, dist_reference_rows


def _rows(n=3000, keys=150, num_steps=3, seed=3, distinct_ts=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, keys, n).astype(np.int32)
    ts = rng.permutation(n).astype(np.int64) * 7 if distinct_ts else rng.integers(0, 40, n).astype(np.int64)
    steps = [rng.random(n) < p for p in (0.5, 0.4, 0.3, 0.3, 0.2)[:num_steps]]
    mask = rng.random(n) < 0.9
    return codes, steps, ts, mask


@pytest.mark.parametrize("num_steps", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [float("inf"), 2500.0])
def test_reach_reference_matches_jax(num_steps, window):
    codes, steps, ts, mask = _rows(num_steps=num_steps)
    cells = 160  # keys 150..159 never occur
    want = np.asarray(_ordered_funnel_reach(
        jnp.asarray(codes), [jnp.asarray(s) for s in steps], jnp.asarray(ts), jnp.asarray(mask), cells, window))
    got = funnel_scan.funnel_reach(
        torch.from_numpy(codes), [torch.from_numpy(s) for s in steps], torch.from_numpy(ts),
        torch.from_numpy(mask), cells, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("window", [float("inf"), 20000.0])
def test_reach_matches_the_jax_tests_oracle(seed, window):
    """The oracle walks rows in stable time order; so does the port, tied
    timestamps included (the world's ts has ties)."""
    rng = np.random.default_rng(seed)
    n, keys = 4000, 120
    uid = rng.integers(0, keys, n).astype(np.int64)
    url = rng.choice(CONDS, n, p=[0.4, 0.3, 0.2, 0.1])
    ts = rng.integers(0, 5_000, n).astype(np.int64)
    reach = _oracle_reach(uid, url, ts, CONDS, window)
    steps = [torch.from_numpy(url == c) for c in CONDS]
    got = funnel_scan.funnel_reach(
        torch.from_numpy(uid), steps, torch.from_numpy(ts), torch.ones(n, dtype=torch.bool), keys, window)
    want = np.zeros(keys, dtype=np.int32)
    for u, r in reach.items():
        want[u] = r
    np.testing.assert_array_equal(got.numpy(), want)


def test_ties_follow_row_order():
    """A step-0 and a step-1 row of one key at the same ts: the port walks
    them in row order (its sort is stable), so the reach depends on which
    comes first.  The JAX sort leaves this order undefined."""
    ts = torch.tensor([5, 5], dtype=torch.int64)
    codes = torch.zeros(2, dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.bool)
    first_then_second = [torch.tensor([True, False]), torch.tensor([False, True])]
    second_then_first = [torch.tensor([False, True]), torch.tensor([True, False])]
    assert funnel_scan.funnel_reach(codes, first_then_second, ts, ones, 1, float("inf")).tolist() == [2]
    assert funnel_scan.funnel_reach(codes, second_then_first, ts, ones, 1, float("inf")).tolist() == [1]


def test_scan_wrapper_takes_plain_version_only_on_cpu():
    codes, steps, ts, mask = _rows(n=500, num_steps=3)
    *runs, cap = funnel_scan.prepare(
        torch.from_numpy(codes), [torch.from_numpy(s) for s in steps], torch.from_numpy(ts),
        torch.from_numpy(mask), 150)
    before = funnel_scan.LAUNCHES
    got = funnel_scan.scan_runs(*runs, cap, 3, 150, 1e9)
    np.testing.assert_array_equal(got.numpy(),
                                  funnel_scan.scan_runs_reference(*runs, cap, 3, 150, 1e9).numpy())
    assert funnel_scan.LAUNCHES == before  # the CPU path launches nothing
    meta = [t.to("meta") for t in runs]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        funnel_scan.scan_runs(*meta, cap, 3, 150, 1e9)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        funnel_scan.scan_runs(runs[0].to(torch.int64), *runs[1:], cap, 3, 150, 1e9)
    with pytest.raises(NotImplementedError, match="1 to 8 STEPS"):
        funnel_scan.prepare(torch.from_numpy(codes), [torch.from_numpy(steps[0])] * 9, torch.from_numpy(ts),
                            torch.from_numpy(mask), 150)


def _events(n, keys, seed, ts_hi, skew=0.0):
    """The JAX tests' event world (one step condition a row), its keys
    uniform below a uniform bound (key k's run ~ n/keys * ln(keys/k): from
    ~5n/keys rows down to one); with skew, that share of the rows on key 0
    and the rest uniform over the other keys."""
    rng = np.random.default_rng(seed)
    uid = rng.integers(0, rng.integers(1, keys + 1, n)).astype(np.int64)
    if skew:
        uid = np.where(rng.random(n) < skew, 0, rng.integers(1, keys, n)).astype(np.int64)
    url = rng.choice(CONDS, n, p=[0.4, 0.3, 0.2, 0.1])
    ts = rng.integers(0, ts_hi, n).astype(np.int64)
    return uid, url, ts


def _oracle_table(uid, url, ts, keys, window):
    want = np.zeros(keys, dtype=np.int32)
    for u, r in _oracle_reach(uid, url, ts, CONDS, window).items():
        want[u] = r
    return want


def _port_reach(uid, url, ts, keys, window):
    steps = [torch.from_numpy(url == c) for c in CONDS]
    return funnel_scan.funnel_reach(torch.from_numpy(uid), steps, torch.from_numpy(ts),
                                    torch.ones(len(uid), dtype=torch.bool), keys, window).numpy()


@pytest.mark.parametrize("cap", [0, 1, 7, 40])
@pytest.mark.parametrize("window", [float("inf"), 300.0])
def test_runs_above_a_lowered_cap_match_the_oracle(monkeypatch, cap, window):
    """Runs longer than RUN_CAP arrive at the scan ordered by prepare (two
    stable sorts over those runs' rows); the rest stay in row order and the
    scan orders them.  Lowering the cap moves runs between the two paths;
    the reach stays the oracle's, ties (ts in [0, 600)) in row order."""
    monkeypatch.setattr(funnel_scan, "RUN_CAP", cap)
    keys = 60
    uid, url, ts = _events(4000, keys, 11, 600)
    steps = [torch.from_numpy(url == c) for c in CONDS]
    run_keys, ts_k, flags_k, starts, counts, ordered_above = funnel_scan.prepare(
        torch.from_numpy(uid), steps, torch.from_numpy(ts), torch.ones(len(uid), dtype=torch.bool), keys)
    assert ordered_above == cap
    longer = counts > cap
    assert bool(longer.any()) and (cap == 0 or not bool(longer.all()))
    # a long run is ordered by (ts, row); a short one is in row order
    row_of = {}
    for k in range(keys):
        row_of[k] = np.flatnonzero(uid == k)
    for r in range(len(run_keys)):
        k, s, c = int(run_keys[r]), int(starts[r]), int(counts[r])
        rows = row_of[k]
        if c > cap:
            rows = rows[np.argsort(ts[rows], kind="stable")]
        np.testing.assert_array_equal(ts_k[s:s + c].numpy(), ts[rows].astype(np.float64))
    got = funnel_scan.scan_runs(run_keys, ts_k, flags_k, starts, counts, ordered_above, len(CONDS), keys, window)
    np.testing.assert_array_equal(got.numpy(), _oracle_table(uid, url, ts, keys, window))


@pytest.mark.parametrize("window", [float("inf"), 2500.0])
def test_one_skewed_key_beside_many_short_ones(window):
    """One key holds ~70% of the rows (a run well above RUN_CAP, ordered by
    prepare) beside ~500 short keys: against the JAX function on distinct
    timestamps and against the oracle with ties."""
    keys = 500
    uid, url, _ = _events(4000, keys, 13, 1, skew=0.7)
    ts = np.random.default_rng(14).permutation(len(uid)).astype(np.int64) * 5
    steps = [torch.from_numpy(url == c) for c in CONDS]
    counts = funnel_scan.prepare(torch.from_numpy(uid), steps, torch.from_numpy(ts),
                                 torch.ones(len(uid), dtype=torch.bool), keys)[4]
    assert int(counts.max()) > funnel_scan.RUN_CAP and int((counts <= 8).sum()) > 300
    want = np.asarray(_ordered_funnel_reach(
        jnp.asarray(uid), [jnp.asarray(url == c) for c in CONDS], jnp.asarray(ts),
        jnp.ones(len(uid), dtype=bool), keys, window))
    np.testing.assert_array_equal(_port_reach(uid, url, ts, keys, window), want)
    tied = ts // 40  # ~40 rows a timestamp
    np.testing.assert_array_equal(_port_reach(uid, url, tied, keys, window),
                                  _oracle_table(uid, url, tied, keys, window))


def test_prepare_sorts_once_when_no_run_passes_the_cap(monkeypatch):
    """One torch.sort (the key) when every run fits the kernel's tile; the
    runs above the cap add their two sorts, and only then."""
    calls = []
    real_sort = torch.sort

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real_sort(*args, **kwargs)

    codes, steps, ts, mask = _rows(n=3000, keys=150, num_steps=3)
    args = (torch.from_numpy(codes), [torch.from_numpy(s) for s in steps], torch.from_numpy(ts),
            torch.from_numpy(mask), 150)
    monkeypatch.setattr(torch, "sort", spy)
    counts = funnel_scan.prepare(*args)[4]
    assert int(counts.max()) <= funnel_scan.RUN_CAP
    assert calls == [torch.Size([3000])]
    calls.clear()
    monkeypatch.setattr(funnel_scan, "RUN_CAP", 20)
    counts = funnel_scan.prepare(*args)[4]
    long_rows = int(counts[counts > 20].sum())
    assert calls == [torch.Size([3000]), torch.Size([long_rows]), torch.Size([long_rows])]


def _operands():
    codes, steps, ts, mask = _rows(n=400, num_steps=3)
    return list(funnel_scan.prepare(torch.from_numpy(codes), [torch.from_numpy(s) for s in steps],
                                    torch.from_numpy(ts), torch.from_numpy(mask), 150))


SCAN_OPERAND_FAULTS = {
    "ts_f32": (lambda o: o.__setitem__(1, o[1].float()), "ts_k must be a contiguous 1-D torch.float64"),
    "flags_bool": (lambda o: o.__setitem__(2, o[2].bool()), "flags_k must be a contiguous 1-D torch.uint8"),
    "starts_i32": (lambda o: o.__setitem__(3, o[3].int()), "starts must be a contiguous 1-D torch.int64"),
    "counts_2d": (lambda o: o.__setitem__(4, o[4][None]), "counts must be a contiguous 1-D"),
    "ts_strided": (lambda o: o.__setitem__(1, torch.repeat_interleave(o[1], 2)[::2]), "ts_k must be a contiguous"),
    "flags_short": (lambda o: o.__setitem__(2, o[2][:-1]), "disagree in length"),
    "counts_short": (lambda o: o.__setitem__(4, o[4][:-1]), "disagree in length"),
    "keys_long": (lambda o: o.__setitem__(0, torch.cat([o[0], o[0][:1]])), "disagree in length"),
    "flags_on_meta": (lambda o: o.__setitem__(2, o[2].to("meta")), "flags_k is on meta, the rows on cpu"),
    "starts_on_meta": (lambda o: o.__setitem__(3, o[3].to("meta")), "starts is on meta, the rows on cpu"),
    "cap_negative": (lambda o: o.__setitem__(5, -1), "ordered_above must be an int"),
    "cap_above_kernel": (lambda o: o.__setitem__(5, funnel_scan.RUN_CAP + 1), "ordered_above must be an int"),
    "cap_float": (lambda o: o.__setitem__(5, 8.0), "ordered_above must be an int"),
    "cap_bool": (lambda o: o.__setitem__(5, True), "ordered_above must be an int"),
}


@pytest.mark.parametrize("fault", list(SCAN_OPERAND_FAULTS))
def test_scan_runs_refuses_bad_operands(fault):
    ops = _operands()
    assert funnel_scan.scan_runs(*ops, 3, 150, 1e9).shape == (150,)  # the untouched operands pass
    edit, message = SCAN_OPERAND_FAULTS[fault]
    edit(ops)
    with pytest.raises(ValueError, match=message.replace("(", r"\(")):
        funnel_scan.scan_runs(*ops, 3, 150, 1e9)


@pytest.mark.parametrize("num_steps", [0, 9])
def test_scan_runs_refuses_step_counts_the_kernel_cannot_carry(num_steps):
    with pytest.raises(ValueError, match="1 to 8 steps"):
        funnel_scan.scan_runs(*_operands(), num_steps, 150, 1e9)


# ---------------------------------------------------------------------------
# SQL parity
# ---------------------------------------------------------------------------
def _events_schema(S):
    return S.Schema(
        "events",
        [
            S.FieldSpec("uid", S.DataType.LONG),
            S.FieldSpec("url", S.DataType.STRING),
            S.FieldSpec("country", S.DataType.STRING),
            S.FieldSpec("ts", S.DataType.LONG),
        ],
    )


@pytest.fixture(scope="module")
def events():
    """{"one" | "partitioned": (jax engine, port engine)}: the events world
    of the JAX funnel tests with (uid, ts) distinct."""
    rng = np.random.default_rng(23)
    n = 4000
    data = {
        "uid": rng.integers(0, 300, n).astype(np.int64),
        "url": rng.choice(CONDS, n, p=[0.4, 0.3, 0.2, 0.1]).astype(object),
        "country": rng.choice(["us", "de", "fr"], n).astype(object),
        "ts": (rng.permutation(n) * 3).astype(np.int64),
    }
    out = {}
    for label, parts in (("one", [np.arange(n)]), ("partitioned", [np.where(data["uid"] % 3 == i)[0]
                                                                    for i in range(3)])):
        je, pe = JaxEngine(), PortEngine(device="cpu")
        je.register_table(_events_schema(jax_schema))
        pe.register_table(_events_schema(port_schema))
        for i, idx in enumerate(parts):
            part = {k: v[idx] for k, v in data.items()}
            je.add_segment("events", jax_build(_events_schema(jax_schema), dict(part), f"s{i}"))
            pe.add_segment("events", port_build(_events_schema(port_schema), dict(part), f"s{i}"))
        out[label] = (je, pe)
    return out


EVENTS_SQL = [
    f"SELECT FUNNELCOUNT({STEPS_SQL}, CORRELATEBY(uid)), FUNNELCOMPLETECOUNT({STEPS_SQL}, CORRELATEBY(uid)), "
    f"FUNNELMAXSTEP({STEPS_SQL}, CORRELATEBY(uid)) FROM events",
    f"SELECT FUNNELCOUNT({STEPS_SQL}, CORRELATEBY(uid), TIMESTAMPBY(ts)), "
    f"FUNNEL_COMPLETE_COUNT({STEPS_SQL}, CORRELATEBY(uid), TIMESTAMPBY(ts), 3000), "
    f"FUNNEL_MAX_STEP({STEPS_SQL}, CORRELATEBY(uid), TIMESTAMPBY(ts)) FROM events",
    "SELECT country, FUNNELCOUNT(STEPS(url = '/home', url = '/cart'), CORRELATEBY(uid), TIMESTAMPBY(ts), 5000), "
    "FUNNEL_COUNT(STEPS(url = '/home', url = '/product', url = '/checkout'), CORRELATEBY(uid)) FROM events "
    "GROUP BY country ORDER BY country LIMIT 10",
    "SELECT FUNNELCOUNT(STEPS(url = '/product', country = 'de'), CORRELATEBY(country), TIMESTAMPBY(ts)), "
    "FUNNELMAXSTEP(STEPS(url = '/home', url = '/home'), CORRELATEBY(url), TIMESTAMPBY(ts), 10) FROM events "
    "WHERE uid < 200",
]


@pytest.mark.parametrize("layout", ["one", "partitioned"])
@pytest.mark.parametrize("sql", EVENTS_SQL, ids=[s[:70] for s in EVENTS_SQL])
def test_segment_engine_matches_jax(events, layout, sql):
    je, pe = events[layout]
    assert_same_rows(pe.query(sql).rows, je.query(sql).rows, ordered="ORDER BY" in sql)


@pytest.fixture(scope="module")
def dist():
    return dist_engines()


DIST_SQL = [
    # chip_smoke query (n)'s shape: each lo_revenue value a user
    "SELECT FUNNELCOUNT(STEPS(disc = 0, q < 10, disc >= 8), CORRELATEBY(rev), TIMESTAMPBY(d), 400) FROM t",
    "SELECT disc, FUNNELMAXSTEP(STEPS(q < 30, q >= 10), CORRELATEBY(rev), TIMESTAMPBY(d)), "
    "FUNNELCOMPLETECOUNT(STEPS(q < 30, yr > 2010), CORRELATEBY(yr)) FROM t GROUP BY disc ORDER BY disc LIMIT 20",
    "SET maxDenseGroups = 2; SELECT disc, FUNNELCOUNT(STEPS(q < 30, q >= 10), CORRELATEBY(q), TIMESTAMPBY(rev)) "
    "FROM t GROUP BY disc ORDER BY disc LIMIT 20",
]


@pytest.mark.parametrize("batching", ["one", "many"])
@pytest.mark.parametrize("sql", DIST_SQL, ids=[s[:70] for s in DIST_SQL])
def test_dist_engine_matches_jax(dist, batching, sql):
    je, sse_ref, pe = dist[batching]
    assert_same_rows(pe.query(sql).rows, dist_reference_rows(je, sse_ref, sql), ordered="ORDER BY" in sql)


def test_parse_refusals_match_jax():
    from pinot_tpu.sql.parser import SqlParseError as JaxErr
    from pinot_tpu.sql.parser import parse_query as jparse

    from pinot_tpu_torch.sql.parser import SqlParseError as PortErr
    from pinot_tpu_torch.sql.parser import parse_query as pparse

    for sql in (f"SELECT FUNNELCOUNT({STEPS_SQL}, CORRELATEBY(uid), 500) FROM events",
                "SELECT FUNNELCOUNT(CORRELATEBY(uid)) FROM events"):
        with pytest.raises(JaxErr) as je:
            jparse(sql)
        with pytest.raises(PortErr) as pe:
            pparse(sql)
        assert str(pe.value) == str(je.value)
    sql = f"SELECT FUNNELCOUNT({STEPS_SQL}, CORRELATEBY(uid), TIMESTAMPBY(ts), 60) FROM events"
    assert pparse(sql).aggregations[0].fingerprint() == jparse(sql).aggregations[0].fingerprint()
