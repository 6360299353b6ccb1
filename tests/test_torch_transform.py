"""The port's transform layer (query/transform.py, query/scalar.py) against
the JAX package's, function family by function family.

One segment, built by each package's own builder from the same numpy data
(a dictionary string column, a nullable string column, int32 / int64 /
float32 / nullable float64 columns, epoch-millisecond timestamps and
lat/lng), goes to the device of each package (the port's on the CPU).  Each
expression is evaluated by pinot_tpu.query.transform.eval_expr and by the
port's eval_expr over the same rows.

Tolerance: the result dtype must be the JAX package's (the promotion and
MOD-by-0 cases are cases of their own); integer and boolean values and the
null masks must be identical; float64 values agree to rtol=1e-12 and
float32 values to rtol=1e-6 (XLA and torch may round a transcendental
function one ulp apart).  expr_int_range must return the same bound, and
the host evaluator used by selections (eval_expr_host) the same values.
"""
import numpy as np
import pytest
import torch

import pinot_tpu  # noqa: F401  (enables jax x64 before any JAX array exists)
from pinot_tpu.query import scalar as jax_scalar
from pinot_tpu.query import transform as jax_transform
from pinot_tpu.segment.builder import build_segment as jax_build
from pinot_tpu.spi import schema as jax_schema
from pinot_tpu.sql.parser import parse_query as jax_parse

from pinot_tpu_torch.query import scalar as port_scalar
from pinot_tpu_torch.query import transform as port_transform
from pinot_tpu_torch.segment.builder import build_segment as port_build
from pinot_tpu_torch.spi import schema as port_schema
from pinot_tpu_torch.sql.parser import parse_query as port_parse

N = 1500
CITIES = ["sf", "nyc", "chi", "la", "sea", "Pdx"]
CPU = torch.device("cpu")


def make_data(seed=11, n=N):
    rng = np.random.default_rng(seed)
    tags = np.asarray([[None, "a", "b", "c"][i] for i in rng.integers(0, 4, n)], dtype=object)
    return {
        "city": rng.choice(CITIES, n).astype(object),
        "tag": tags,
        "i": rng.integers(-200, 1000, n).astype(np.int32),
        "l": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "f": (rng.random(n) * 200 - 50).astype(np.float32),
        "d": np.where(rng.random(n) < 0.2, np.nan, np.round(rng.random(n) * 1000 - 100, 4)),
        # 1995-2030 in epoch milliseconds: every calendar boundary and DST shift
        "ts": rng.integers(788_918_400_000, 1_893_456_000_000, n).astype(np.int64),
        "lat": rng.random(n) * 180 - 90,
        "lng": rng.random(n) * 360 - 180,
    }


def make_schema(S):
    return S.Schema(
        "t",
        [
            S.FieldSpec("city", S.DataType.STRING),
            S.FieldSpec("tag", S.DataType.STRING, nullable=True),
            S.FieldSpec("i", S.DataType.INT),
            S.FieldSpec("l", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("f", S.DataType.FLOAT, role=S.FieldRole.METRIC),
            S.FieldSpec("d", S.DataType.DOUBLE, role=S.FieldRole.METRIC, nullable=True),
            S.FieldSpec("ts", S.DataType.LONG, role=S.FieldRole.METRIC),
            S.FieldSpec("lat", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
            S.FieldSpec("lng", S.DataType.DOUBLE, role=S.FieldRole.METRIC),
        ],
    )


@pytest.fixture(scope="module")
def segments():
    data = make_data()
    jseg = jax_build(make_schema(jax_schema), dict(data), "t0")
    pseg = port_build(make_schema(port_schema), dict(data), "t0")
    return jseg, jseg.to_device(), pseg, pseg.to_device(CPU)


# family -> expressions (SQL select items)
FAMILIES = {
    "arithmetic": [
        "i + 1", "i - l", "i * i", "l * 3", "f + i", "l + f", "d - i", "i / 3", "i / 0", "l / f",
        "-i", "ABS(i - 50)", "FLOOR(d)", "CEIL(f)", "FLOOR(i)", "SIGN(i - 50)", "POW(i, 2)",
        "EXP(i / 100)", "LN(d)", "LOG10(l)", "SQRT(i)", "SQRT(ABS(l))", "SQRT(f)", "i * 2 + 1 - l",
    ],
    # a Python float literal: float64 beside an integer column (JAX's weak
    # float), float32 beside a float32 one
    "promotion": ["i * 2.5", "l * 1.5", "f * 2.5", "i + 0.5", "2.5 - i", "(i + 1) * 1.1", "d * 2"],
    "mod_by_zero": ["MOD(i, 0)", "MOD(l, 0)", "MOD(f, 0)", "MOD(i, 7)", "MOD(i, -7)", "MOD(d, 2.5)", "i % 3"],
    "cast": ["CAST(i AS DOUBLE)", "CAST(l AS FLOAT)", "CAST(f AS INT)", "CAST(f AS LONG)", "CAST(i AS LONG) * 3"],
    "least_greatest": ["LEAST(i, 500)", "GREATEST(i, l, 3)", "LEAST(f, 2.5)", "GREATEST(d, i)", "LEAST(i, 2.5)"],
    "case": [
        "CASE WHEN i > 500 THEN i ELSE 0 END",
        "CASE WHEN i > 500 THEN 1 ELSE 0 END",
        "(CASE WHEN i > 500 THEN 1 ELSE 0 END) * i",
        "CASE WHEN tag = 'a' THEN d WHEN tag IN ('b', 'c') THEN i END",
        "CASE WHEN d IS NULL THEN -1 ELSE d END",
        "CASE WHEN NOT (i < 100 OR i >= 900) THEN l * 2 ELSE l END",
        "CASE WHEN city = 'sf' THEN 2.5 WHEN city IN ('la', 'nyc') THEN i END",
        "CASE WHEN i BETWEEN 10 AND 20 THEN f ELSE d END",
        "CASE WHEN i IN (1, 2, 3) THEN 1 WHEN tag IS NULL THEN 2 ELSE 3 END",
    ],
    "datetime": [
        "YEAR(ts)", "QUARTER(ts)", "MONTH(ts)", "WEEK(ts)", "DAY(ts)", "DAYOFWEEK(ts)", "DAYOFYEAR(ts)",
        "HOUR(ts)", "MINUTE(ts)", "SECOND(ts)", "MILLISECOND(ts)",
        "DATETRUNC('second', ts)", "DATETRUNC('hour', ts)", "DATETRUNC('day', ts)", "DATETRUNC('week', ts)",
        "DATETRUNC('month', ts)", "DATETRUNC('quarter', ts)", "DATETRUNC('year', ts)",
        "TIMECONVERT(ts, 'MILLISECONDS', 'HOURS')",
        "DATETIMECONVERT(ts, '1:MILLISECONDS:EPOCH', '1:HOURS:EPOCH', '1:DAYS')",
    ],
    "datetime_tz": [
        "YEAR(ts, 'America/Los_Angeles')", "HOUR(ts, 'Asia/Kolkata')", "DAYOFWEEK(ts, 'Pacific/Auckland')",
        "DATETRUNC('day', ts, 'MILLISECONDS', 'Europe/Berlin')",
        "DATETRUNC('month', ts, 'MILLISECONDS', 'America/New_York', 'DAYS')",
        "DATETRUNC('hour', ts, 'MILLISECONDS', 'UTC')",
    ],
    "round_trig_geo": [
        "ROUND(d, 2)", "ROUND(i)", "ROUND(i, 1)", "TRUNCATE(f, 1)", "TRUNCATE(d)", "SIN(i)", "COS(l)",
        "DEGREES(d)", "RADIANS(f)", "ST_DISTANCE(lat, lng, 37.7, -122.4)", "GEOGRID(lat, lng, 6)",
        "ATAN2(lat, lng)", "POWER(i, 2)",
    ],
    "dictionary": ["LENGTH(city)", "STRPOS(city, 'a')", "STARTSWITH(city, 's')", "LENGTH(city) * 2",
                   "CODEPOINT(city)"],
}
CASES = [(fam, e) for fam, exprs in FAMILIES.items() for e in exprs]


def _expr(parse, text):
    return parse(f"SELECT {text} FROM t").select_list[0]


def _assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        rtol = 1e-6 if want.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("family,text", CASES, ids=[f"{f}:{e}" for f, e in CASES])
def test_eval_expr_matches_jax(segments, family, text):
    jseg, jcols, pseg, pcols = segments
    jv, jn = jax_transform.eval_expr(_expr(jax_parse, text), jseg, jcols)
    pv, pn = port_transform.eval_expr(_expr(port_parse, text), pseg, pcols, CPU)
    _assert_same(pv.numpy(), np.asarray(jv), text)
    assert (pn is None) == (jn is None), text
    if jn is not None:
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn), err_msg=text)


@pytest.mark.parametrize("family,text", CASES, ids=[f"{f}:{e}" for f, e in CASES])
def test_expr_int_range_matches_jax(segments, family, text):
    jseg, _, pseg, _ = segments
    assert port_scalar.expr_int_range(_expr(port_parse, text), pseg) == jax_scalar.expr_int_range(
        _expr(jax_parse, text), jseg
    )


HOST_CASES = [c for c in CASES if c[0] in ("arithmetic", "promotion", "mod_by_zero", "case", "datetime",
                                           "dictionary")]


@pytest.mark.parametrize("family,text", HOST_CASES, ids=[f"{f}:{e}" for f, e in HOST_CASES])
def test_eval_expr_host_matches_jax(segments, family, text):
    """The selection path's host evaluation over a row subset; where the
    JAX package refuses an expression there, the port raises the same
    exception class."""
    jseg, _, pseg, _ = segments
    docids = np.arange(3, N, 7)
    try:
        want = jax_transform.eval_expr_host(_expr(jax_parse, text), jseg, docids)
    except (TypeError, ValueError) as e:
        with pytest.raises(type(e)):
            port_transform.eval_expr_host(_expr(port_parse, text), pseg, docids)
        return
    got = port_transform.eval_expr_host(_expr(port_parse, text), pseg, docids)
    if np.asarray(want).dtype == object:
        assert list(got) == list(want), text
    else:
        _assert_same(got, want, text)


def test_python_float_promotion_is_the_jax_packages():
    """int32 * 2.5 is float64 in the JAX package (weak float), float32 in
    plain torch; float32 * 2.5 stays float32 in both."""
    i32 = torch.arange(5, dtype=torch.int32)
    assert (i32 * 2.5).dtype == torch.float32  # plain torch
    assert port_transform._binop(torch.mul, i32, False, 2.5, True)[0].dtype == torch.float64
    assert port_transform._binop(torch.mul, i32.float(), False, 2.5, True)[0].dtype == torch.float32
    assert port_transform._binop(torch.mul, i32, False, 3, True)[0].dtype == torch.int32


def test_mod_by_zero_is_zero_not_an_error():
    x = torch.tensor([-7, 0, 7], dtype=torch.int32)
    with pytest.raises(RuntimeError):
        torch.remainder(x, torch.zeros_like(x))  # what plain torch does on the CPU
    out, _ = port_transform._binop(port_transform._mod, x, False, 0, True)
    assert out.dtype == torch.int32 and out.tolist() == [0, 0, 0]
    out, _ = port_transform._binop(port_transform._mod, x, False, -3, True)
    assert out.tolist() == [-1, 0, -2]  # floor sign, as jnp.mod


def test_string_results_never_materialize(segments):
    jseg, jcols, pseg, pcols = segments
    for parse, fn, seg, cols, extra in ((jax_parse, jax_transform.eval_expr, jseg, jcols, ()),
                                        (port_parse, port_transform.eval_expr, pseg, pcols, (CPU,))):
        with pytest.raises(ValueError, match="never materializes"):
            fn(_expr(parse, "UPPER(city)"), seg, cols, *extra)
        with pytest.raises(ValueError, match="string values never materialize"):
            fn(_expr(parse, "city"), seg, cols, *extra)


@pytest.mark.parametrize("fn", ["upper", "substr", "concat", "length", "splitpart", "md5", "fromdatetime",
                                "json_extract_scalar"])
def test_dict_fns_are_the_jax_packages(fn):
    values = np.asarray(["2024-01-05", "a,b,c", "{\"k\": 3}", "Sf"], dtype=object)
    args = {"substr": (1, 2), "concat": ("-x",), "splitpart": (",", 1), "fromdatetime": ("yyyy-MM-dd",),
            "json_extract_scalar": ("$.k", "INT", 0)}.get(fn, ())
    want = jax_scalar.DICT_FNS[fn](values, *args)
    got = port_scalar.DICT_FNS[fn](values, *args)
    assert got.dtype == want.dtype and list(got) == list(want)


def test_tz_table_is_the_jax_packages():
    for tz in ("America/New_York", "Asia/Kolkata"):
        for a, b in zip(port_scalar._tz_table(tz), jax_scalar._tz_table(tz)):
            np.testing.assert_array_equal(a, b)
