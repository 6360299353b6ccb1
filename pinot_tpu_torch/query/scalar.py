"""Scalar function library: datetime device functions, dictionary-domain
string functions, interval analysis.

Port of pinot_tpu/query/scalar.py.  Two execution domains, as there:

* DEVICE_FNS / DEVICE_MULTI_FNS - numeric and datetime functions over
  tensors, eager torch ops on the plan's device.  Calendar math uses Howard
  Hinnant's civil-date algorithms on int64 tensors: torch's `//` and `%`
  on integer tensors floor (as jnp.floor_divide / jnp.mod do), which the
  algorithms rely on.  Time zones resolve per row through a host-built
  (transition instant, offset) table and a searchsorted on the device.
  Float results take the JAX package's dtypes: an int32 operand of a
  float function gives float32, an int64 one float64 (torch would give
  float32 for both).

* DICT_FNS - string functions evaluated on the host over a DICTIONARY'S
  VALUES (cardinality-sized numpy work); the device gathers the derived
  per-code array, f(values)[codes].  Copied from the JAX package as is.

expr_int_range bounds integer expressions from column stats (it sizes the
"expr" group-by dimensions); for DATETRUNC/YEAR/TIMECONVERT it calls this
module's own torch functions on one-element CPU tensors.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

MS_SECOND = 1000
MS_MINUTE = 60 * MS_SECOND
MS_HOUR = 60 * MS_MINUTE
MS_DAY = 24 * MS_HOUR
MS_WEEK = 7 * MS_DAY

TIME_UNIT_MS = {
    "MILLISECONDS": 1,
    "SECONDS": MS_SECOND,
    "MINUTES": MS_MINUTE,
    "HOURS": MS_HOUR,
    "DAYS": MS_DAY,
}


def inexact(v: torch.Tensor) -> torch.Tensor:
    """A tensor in the float dtype the JAX package computes a float function
    of it in: floats stay, 8-byte integers take float64, narrower integers
    and bool float32."""
    if v.is_floating_point():
        return v
    return v.to(torch.float64 if v.element_size() >= 8 else torch.float32)


# ---------------------------------------------------------------------------
# Civil-date math (Hinnant algorithms; exact integer ops, vectorized).
# torch integer // is floor division, so no truncation-era fixups needed.
# ---------------------------------------------------------------------------
def civil_from_days(days):
    """Epoch days -> (year, month 1-12, day 1-31)."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 - 12 * (mp // 10)
    return y + (m <= 2).to(torch.int64), m, d


def days_from_civil(y, m, d):
    """(year, month, day) -> epoch days."""
    y = y - (m <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + torch.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _epoch_days(ms):
    return ms.to(torch.int64) // MS_DAY


def _day_of_week_iso(days):
    """ISO day-of-week 1=Monday..7=Sunday (epoch day 0 was a Thursday)."""
    return (days + 3) % 7 + 1


def _doy(ms):
    y, m, d = civil_from_days(_epoch_days(ms))
    return _epoch_days(ms) - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1


def _week_of_year(ms):
    """ISO-8601 week number: the week containing this date's Thursday."""
    days = _epoch_days(ms)
    thursday = days - ((days + 3) % 7) + 3
    y, _, _ = civil_from_days(thursday)
    jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return (thursday - jan1) // 7 + 1


def date_trunc(unit: str, ms):
    """DATETRUNC(unit, epoch_millis) -> epoch millis at bucket start."""
    unit = unit.lower()
    ms = ms.to(torch.int64)
    if unit == "millisecond":
        return ms
    if unit == "second":
        return (ms // MS_SECOND) * MS_SECOND
    if unit == "minute":
        return (ms // MS_MINUTE) * MS_MINUTE
    if unit == "hour":
        return (ms // MS_HOUR) * MS_HOUR
    if unit == "day":
        return (ms // MS_DAY) * MS_DAY
    if unit == "week":  # ISO week: truncate to Monday
        days = _epoch_days(ms)
        return (days - (days + 3) % 7) * MS_DAY
    y, m, _ = civil_from_days(_epoch_days(ms))
    one = torch.ones_like(m)
    if unit == "month":
        return days_from_civil(y, m, one) * MS_DAY
    if unit == "quarter":
        qm = ((m - 1) // 3) * 3 + 1
        return days_from_civil(y, qm, one) * MS_DAY
    if unit == "year":
        return days_from_civil(y, one, one) * MS_DAY
    raise ValueError(f"DATETRUNC: unknown unit {unit!r}")


def _extract(part: str, ms):
    ms = ms.to(torch.int64)
    part = part.lower()
    if part == "millisecond":
        return ms % MS_SECOND
    if part == "second":
        return (ms // MS_SECOND) % 60
    if part == "minute":
        return (ms // MS_MINUTE) % 60
    if part == "hour":
        return (ms // MS_HOUR) % 24
    days = _epoch_days(ms)
    if part in ("dayofweek", "dow"):
        return _day_of_week_iso(days) % 7 + 1  # SQL: 1=Sunday..7=Saturday
    if part in ("dayofyear", "doy"):
        return _doy(ms)
    if part == "week":
        return _week_of_year(ms)
    y, m, d = civil_from_days(days)
    if part == "year":
        return y
    if part == "quarter":
        return (m - 1) // 3 + 1
    if part == "month":
        return m
    if part in ("day", "dayofmonth"):
        return d
    raise ValueError(f"unknown datetime part {part!r}")


def time_convert(ms, from_unit: str, to_unit: str):
    """TIMECONVERT(col, fromUnit, toUnit) — epoch unit rescale."""
    f = TIME_UNIT_MS[from_unit.upper()]
    t = TIME_UNIT_MS[to_unit.upper()]
    return (ms.to(torch.int64) * f) // t


def _parse_dt_format(fmt: str) -> Tuple[int, str]:
    """Pinot datetime format '1:MILLISECONDS:EPOCH' / 'EPOCH|SECONDS|1'
    -> (unit-size-in-ms, 'EPOCH').  SIMPLE_DATE_FORMAT is host/dictionary
    territory and rejected here."""
    parts = fmt.split("|") if "|" in fmt else fmt.split(":")
    if "|" in fmt:
        kind = parts[0].upper()
        unit = parts[1].upper() if len(parts) > 1 else "MILLISECONDS"
        size = int(parts[2]) if len(parts) > 2 and parts[2] else 1
    else:
        size = int(parts[0])
        unit = parts[1].upper()
        kind = parts[2].upper() if len(parts) > 2 else "EPOCH"
    if kind != "EPOCH":
        raise ValueError(f"SIMPLE_DATE_FORMAT not supported on device: {fmt!r}")
    return size * TIME_UNIT_MS[unit], kind


def datetime_convert(col, in_fmt: str, out_fmt: str, granularity: str):
    """DATETIMECONVERT(col, inFmt, outFmt, granularity) for EPOCH formats:
    rescale + bucket (DateTimeConversionTransformFunction)."""
    in_ms, _ = _parse_dt_format(in_fmt)
    out_ms, _ = _parse_dt_format(out_fmt)
    g = granularity.split(":")
    gran_ms = int(g[0]) * TIME_UNIT_MS[g[1].upper()]
    ms = col.to(torch.int64) * in_ms
    bucketed = (ms // gran_ms) * gran_ms
    return bucketed // out_ms


# ---------------------------------------------------------------------------
# DEVICE_FNS registry: name -> fn(tensor, *literal_args)
# ---------------------------------------------------------------------------
def _rounder(v, *args):
    if not args:
        return torch.round(v)
    # ROUND(x, d): d decimal places; a Python float scale makes an integer
    # operand float64 (JAX's weak-float promotion), a float one keeps its dtype
    scale = 10.0 ** int(args[0])
    w = v if v.is_floating_point() else v.to(torch.float64)
    return torch.round(w * scale) / scale


def _truncator(v, *args):
    scale = 10.0 ** (int(args[0]) if args else 0)
    w = v if v.is_floating_point() else v.to(torch.float64)
    return torch.trunc(w * scale) / scale


def _float_fn(fn):
    return lambda v: fn(inexact(v))


DEVICE_FNS: Dict[str, Callable] = {
    "datetrunc": lambda v, unit, *rest: _date_trunc_args(str(unit), v, rest),
    "year": lambda v, *a: _extract("year", _dt_ms(v, a)),
    "quarter": lambda v, *a: _extract("quarter", _dt_ms(v, a)),
    "month": lambda v, *a: _extract("month", _dt_ms(v, a)),
    "week": lambda v, *a: _extract("week", _dt_ms(v, a)),
    "weekofyear": lambda v, *a: _extract("week", _dt_ms(v, a)),
    "day": lambda v, *a: _extract("day", _dt_ms(v, a)),
    "dayofmonth": lambda v, *a: _extract("day", _dt_ms(v, a)),
    "dayofweek": lambda v, *a: _extract("dayofweek", _dt_ms(v, a)),
    "dayofyear": lambda v, *a: _extract("dayofyear", _dt_ms(v, a)),
    "hour": lambda v, *a: _extract("hour", _dt_ms(v, a)),
    "minute": lambda v, *a: _extract("minute", _dt_ms(v, a)),
    "second": lambda v, *a: _extract("second", _dt_ms(v, a)),
    "millisecond": lambda v, *a: _extract("millisecond", _dt_ms(v, a)),
    "timeconvert": lambda v, fu, tu: time_convert(v, str(fu), str(tu)),
    "datetimeconvert": lambda v, i, o, g: datetime_convert(v, str(i), str(o), str(g)),
    "round": _rounder,
    "truncate": _truncator,
    "sin": _float_fn(torch.sin),
    "cos": _float_fn(torch.cos),
    "tan": _float_fn(torch.tan),
    "asin": _float_fn(torch.asin),
    "acos": _float_fn(torch.acos),
    "atan": _float_fn(torch.atan),
    "sinh": _float_fn(torch.sinh),
    "cosh": _float_fn(torch.cosh),
    "tanh": _float_fn(torch.tanh),
    "degrees": _float_fn(torch.rad2deg),
    "radians": _float_fn(torch.deg2rad),
}


# ---------------------------------------------------------------------------
# Geo functions (device): haversine distance + quantized grid cells, as in
# the JAX package (GEOGRID is its lat/lng quantization, not H3).
# ---------------------------------------------------------------------------
_EARTH_RADIUS_M = 6371008.8


def _f64(*args):
    """The arguments as float64 tensors, literals as 0-dim fills on the
    device of the tensor arguments."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    return [a.to(torch.float64) if isinstance(a, torch.Tensor)
            else torch.full((), float(a), dtype=torch.float64, device=dev) for a in args]


def st_distance(lat1, lng1, lat2, lng2):
    """Great-circle distance in meters (haversine), any mix of tensors and
    scalars."""
    lat1, lng1, lat2, lng2 = _f64(lat1, lng1, lat2, lng2)
    to_rad = math.pi / 180.0
    p1 = lat1 * to_rad
    p2 = lat2 * to_rad
    dphi = (lat2 - lat1) * to_rad
    dlmb = (lng2 - lng1) * to_rad
    a = torch.sin(dphi / 2) ** 2 + torch.cos(p1) * torch.cos(p2) * torch.sin(dlmb / 2) ** 2
    return 2.0 * _EARTH_RADIUS_M * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def geogrid(lat, lng, precision):
    """Quantized geo cell id: a 2^p x 2^p lat/lng grid (cell = row * 2^p +
    col, groupable via expr_int_range)."""
    n = 1 << int(precision)
    lat, lng = _f64(lat, lng)
    cx = torch.clamp(((lng + 180.0) / 360.0 * n).to(torch.int64), 0, n - 1)
    cy = torch.clamp(((lat + 90.0) / 180.0 * n).to(torch.int64), 0, n - 1)
    return cy * n + cx


def _atan2(y, x):
    return torch.atan2(*_f64(y, x))


def _power(a, b):
    return torch.pow(*_f64(a, b))


# multi-argument device functions: fn(*evaluated_args) — args arrive in SQL
# order, literals as Python scalars, columns/exprs as tensors
DEVICE_MULTI_FNS: Dict[str, Callable] = {
    "st_distance": st_distance,
    "stdistance": st_distance,
    "geogrid": geogrid,
    "atan2": _atan2,
    "power": _power,
}


def _in_ms(v, unit_args):
    """Optional trailing inputTimeUnit literal rescales the epoch to millis
    (DATETRUNC('day', ts, 'SECONDS') — Pinot's extended form)."""
    if unit_args:
        v = v.to(torch.int64) * TIME_UNIT_MS[str(unit_args[0]).upper()]
    return v


# ---------------------------------------------------------------------------
# Timezones: each zone compiles ONCE into a (transition instants, offset)
# table by stdlib zoneinfo probing (the JAX package's table, same code), and
# the device resolves per-row offsets with a searchsorted over it.
# ---------------------------------------------------------------------------
_TZ_YEARS = (1970, 2080)


@functools.lru_cache(maxsize=None)
def _tz_table(tz_name: str):
    """(transition_ms int64[n], offset_ms int64[n]): offset_ms[i] is the
    zone's UTC offset from transition_ms[i] (until the next entry).  Built
    by ~monthly probing with bisection to 1 ms precision (zoneinfo exposes
    no transition list; real transitions are >1 month apart), so no
    instant within a minute of a DST shift is misplaced."""
    import datetime as _dt

    try:
        from zoneinfo import ZoneInfo

        tz = ZoneInfo(tz_name)
    except Exception as e:  # unknown zone: match Pinot's error surface
        raise ValueError(f"unknown time zone {tz_name!r}") from e

    def off(ms_v: int) -> int:
        # fromtimestamp(tz=tz) localizes the INSTANT; utcoffset() then reads
        # the zone's offset at it (ZoneInfo.utcoffset(naive_utc) would treat
        # the UTC wall reading as local time — hours off near transitions)
        return int(_dt.datetime.fromtimestamp(ms_v / 1000, tz=tz).utcoffset().total_seconds() * 1000)

    y0, y1 = _TZ_YEARS
    start = int(_dt.datetime(y0, 1, 1, tzinfo=_dt.timezone.utc).timestamp() * 1000)
    end = int(_dt.datetime(y1, 1, 1, tzinfo=_dt.timezone.utc).timestamp() * 1000)
    step = 28 * MS_DAY
    trans = [np.iinfo(np.int64).min]
    offs = [off(start)]
    t = start
    while t < end:
        nt = min(t + step, end)
        o = off(nt)
        if o != offs[-1]:
            lo, hi = t, nt
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if off(mid) == offs[-1]:
                    lo = mid
                else:
                    hi = mid
            trans.append(hi)
            offs.append(o)
        t = nt
    return np.asarray(trans, np.int64), np.asarray(offs, np.int64)


def _tz_offset_ms(ms, tz_name: str):
    trans, offs = _tz_table(tz_name)
    t = torch.from_numpy(trans).to(ms.device)
    idx = torch.clamp(torch.searchsorted(t, ms.contiguous(), right=True) - 1, 0, len(offs) - 1)
    return torch.from_numpy(offs).to(ms.device)[idx]


def _split_dt_args(args):
    """Pinot's (col[, inputTimeUnit][, tzId][, outputTimeUnit]) literal tail
    -> (unit list in order, tz or None).  Literals naming a TimeUnit are
    units (first = input, second = output — the 5-arg dateTrunc form);
    anything else is the zone id."""
    unit_args, tz = [], None
    for a in args:
        s = str(a)
        if s.upper() in TIME_UNIT_MS:
            unit_args.append(s)
        else:
            tz = s
    if tz is not None and tz.upper() in ("UTC", "GMT", "Z"):
        tz = None
    return unit_args, tz


def _dt_ms(v, args):
    """Input millis shifted into the arg-designated zone's local time."""
    unit_args, tz = _split_dt_args(args)
    ms = _in_ms(v, unit_args[:1]).to(torch.int64)
    if tz is not None:
        ms = ms + _tz_offset_ms(ms, tz)
    return ms


def _date_trunc_args(unit: str, v, rest):
    """DATETRUNC(unit, col[, inputTimeUnit][, tz][, outputTimeUnit]):
    truncate in local wall time; result in outputTimeUnit (default millis).
    The instant's own offset maps the bucket start back — exact except for
    buckets that straddle a DST shift (the JAX package's documented delta)."""
    unit_args, tz = _split_dt_args(rest)
    ms = _in_ms(v, unit_args[:1]).to(torch.int64)
    if tz is None:
        out = date_trunc(unit, ms)
    else:
        o = _tz_offset_ms(ms, tz)
        out = date_trunc(unit, ms + o) - o
    if len(unit_args) > 1:
        out = out // TIME_UNIT_MS[str(unit_args[1]).upper()]
    return out


# ---------------------------------------------------------------------------
# DICT_FNS: host string functions over dictionary values.
# fn(np object array of values, *literal args) -> derived np array
# (object array for string results, numeric array for numeric results).
# ---------------------------------------------------------------------------
def _sv(fn):
    """Lift a python str->Any function to an object-array map."""

    def apply(values: np.ndarray, *args):
        return np.array([fn(v, *args) for v in values], dtype=object)

    return apply


def _sv_num(fn, dtype=np.int64):
    def apply(values: np.ndarray, *args):
        return np.array([fn(v, *args) for v in values], dtype=dtype)

    return apply


def _substr(v: str, start, length=None):
    # Pinot SUBSTR is 0-based; length -1 / omitted = to end
    s = int(start)
    if length is None or int(length) < 0:
        return v[s:]
    return v[s : s + int(length)]


DICT_FNS: Dict[str, Callable] = {
    "upper": _sv(lambda v: v.upper()),
    "lower": _sv(lambda v: v.lower()),
    "trim": _sv(lambda v: v.strip()),
    "ltrim": _sv(lambda v: v.lstrip()),
    "rtrim": _sv(lambda v: v.rstrip()),
    "reverse": _sv(lambda v: v[::-1]),
    "substr": _sv(_substr),
    "substring": _sv(_substr),
    "concat": _sv(lambda v, *args: v + "".join(str(a) for a in args)),
    "replace": _sv(lambda v, find, repl: v.replace(str(find), str(repl))),
    "lpad": _sv(lambda v, size, pad: v.rjust(int(size), str(pad))),
    "rpad": _sv(lambda v, size, pad: v.ljust(int(size), str(pad))),
    # numeric results: gathered on device as derived[codes]
    "length": _sv_num(len),
    "strpos": _sv_num(lambda v, find, *inst: v.find(str(find))),
    "startswith": _sv_num(lambda v, p: int(v.startswith(str(p))), np.uint8),
    "endswith": _sv_num(lambda v, p: int(v.endswith(str(p))), np.uint8),
    "containsstr": _sv_num(lambda v, p: int(str(p) in v), np.uint8),
}


# -- string/url/hash breadth (StringFunctions.java, UrlFunctions.java,
# HashFunctions.java; regexpExtract/regexpReplace from RegexpFunctions) ----
def _split_part(v: str, delim, a, *b):
    """splitPart(input, delim, index) or the reference's 4-arg
    (input, delim, limit, index) form — limit bounds the SPLIT COUNT
    (StringFunctions.splitPart), not a default value."""
    if b:
        limit, i = int(a), int(b[0])
        parts = str(v).split(str(delim), max(0, limit - 1))
    else:
        i = int(a)
        parts = str(v).split(str(delim))
    if 0 <= i < len(parts):
        return parts[i]
    return "null"  # Pinot's miss marker


def _regexp_extract(v: str, pattern, *args):
    group = int(args[0]) if args else 0
    default = str(args[1]) if len(args) > 1 else ""
    m = re.search(str(pattern), str(v))
    if m is None:
        return default
    try:
        return m.group(group) or default
    except IndexError:
        return default


def _regexp_replace(v: str, pattern, repl, *args):
    """regexpReplace(value, regex, replace[, matchStartPos[, occurrence
    [, flags]]]) — occurrence k >= 0 replaces only the k-th match (0-based),
    -1 (default) replaces all; flags: 'i' case-insensitive
    (RegexpReplaceTransformFunction signature)."""
    s = str(v)
    start = int(args[0]) if args else 0
    occurrence = int(args[1]) if len(args) > 1 else -1
    fl = re.IGNORECASE if len(args) > 2 and "i" in str(args[2]).lower() else 0
    head, tail = s[:start], s[start:]
    if occurrence < 0:
        return head + re.sub(str(pattern), str(repl), tail, flags=fl)
    rx = re.compile(str(pattern), fl)
    k = -1
    out = []
    pos = 0
    for m in rx.finditer(tail):
        k += 1
        if k == occurrence:
            out.append(tail[pos : m.start()])
            out.append(m.expand(str(repl)))
            pos = m.end()
            break
    out.append(tail[pos:])
    return head + "".join(out)


def _hash_fn(algo):
    import hashlib

    def apply(v):
        h = hashlib.new(algo)
        h.update(v.encode() if isinstance(v, str) else bytes(v))
        return h.hexdigest()

    return apply


def _url_encode(v: str) -> str:
    from urllib.parse import quote_plus

    return quote_plus(str(v))


def _url_decode(v: str) -> str:
    from urllib.parse import unquote_plus

    return unquote_plus(str(v))


def _b64(v: str) -> str:
    import base64

    return base64.b64encode(v.encode() if isinstance(v, str) else bytes(v)).decode()


def _b64d(v: str) -> str:
    import base64

    return base64.b64decode(str(v)).decode()


DICT_FNS.update(
    {
        "splitpart": _sv(_split_part),
        "split_part": _sv(_split_part),
        "repeat": _sv(lambda v, n, *sep: (str(sep[0]) if sep else "").join([v] * int(n))),
        "regexpextract": _sv(_regexp_extract),
        "regexp_extract": _sv(_regexp_extract),
        "regexpreplace": _sv(_regexp_replace),
        "regexp_replace": _sv(_regexp_replace),
        "urlencode": _sv(_url_encode),
        "urldecode": _sv(_url_decode),
        "encodeurl": _sv(_url_encode),
        "decodeurl": _sv(_url_decode),
        "md5": _sv(_hash_fn("md5")),
        "sha": _sv(_hash_fn("sha1")),
        "sha256": _sv(_hash_fn("sha256")),
        "sha512": _sv(_hash_fn("sha512")),
        "tobase64": _sv(_b64),
        "frombase64": _sv(_b64d),
        "codepoint": _sv_num(lambda v: ord(str(v)[0]) if str(v) else 0),
        "chr": _sv(lambda v: chr(int(v))),
    }
)

def _json_extract(values: np.ndarray, path, rtype, default=None) -> np.ndarray:
    """JSON_EXTRACT_SCALAR(col, '$.path', 'type'[, default]) over dictionary
    values (JsonExtractScalarTransformFunction analog, evaluated per
    dictionary entry).  Path: $.a.b.c and [i] array access."""
    import json as _json

    rtype = str(rtype).upper()
    steps = []
    for part in str(path).lstrip("$").strip(".").split("."):
        if not part:
            continue
        base, _, rest = part.partition("[")
        if base:
            steps.append(("key", base))
        while rest:
            idx, _, rest = rest.partition("]")
            steps.append(("idx", int(idx)))
            rest = rest.lstrip("[")
    nulls = {"INT": -(2**31), "LONG": -(2**63), "FLOAT": float("-inf"), "DOUBLE": float("-inf"), "STRING": "null"}
    missing = default if default is not None else nulls.get(rtype, "null")

    def one(v):
        try:
            node = _json.loads(v)
        except (TypeError, ValueError):
            return missing
        for kind, s in steps:
            try:
                node = node[s]
            except (KeyError, IndexError, TypeError):
                return missing
        if isinstance(node, (dict, list)):
            return _json.dumps(node) if rtype == "STRING" else missing
        return node

    out = [one(v) for v in values]
    if rtype in ("INT", "LONG"):
        return np.array([int(x) if not isinstance(x, str) else int(float(x)) for x in out], dtype=np.int64)
    if rtype in ("FLOAT", "DOUBLE"):
        return np.array([float(x) for x in out], dtype=np.float64)
    return np.array([str(x) for x in out], dtype=object)


DICT_FNS["json_extract_scalar"] = _json_extract


def _java_fmt_to_strptime(fmt: str) -> str:
    """Joda/SimpleDateFormat pattern -> strptime (the subset Pinot docs use:
    yyyy MM dd HH mm ss SSS, plus 'quoted' literal sections like 'T')."""
    import re as _re

    out = fmt
    # SSS first: translating ss earlier would leave %S adjacent to SSS and
    # corrupt the pattern (ssSSS -> %SSSS mis-splits)
    for a, b in (
        ("SSS", "%f"),  # strptime %f = microseconds; see callers
        ("yyyy", "%Y"),
        ("MM", "%m"),
        ("dd", "%d"),
        ("HH", "%H"),
        ("mm", "%M"),
        ("ss", "%S"),
    ):
        out = out.replace(a, b)
    # SimpleDateFormat quotes literal text: yyyy-MM-dd'T'HH:mm:ss
    return _re.sub(r"'([^']*)'", r"\1", out)


def _from_datetime(values: np.ndarray, fmt: str, tz_name: Optional[str] = None) -> np.ndarray:
    """FROMDATETIME(strCol, 'yyyy-MM-dd ...'[, tzId]) -> epoch millis; the
    string is interpreted as wall time in tzId (default UTC).  Runs over the
    DICTIONARY (cardinality work) like all string functions."""
    import datetime as _dt

    tzinfo = _dt.timezone.utc
    if tz_name is not None and str(tz_name).upper() not in ("UTC", "GMT", "Z"):
        from zoneinfo import ZoneInfo

        tzinfo = ZoneInfo(str(tz_name))
    py_fmt = _java_fmt_to_strptime(str(fmt))
    has_millis = "%f" in py_fmt
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        s = str(v)
        if has_millis:
            # SSS is milliseconds; pad to microseconds for %f
            base, _, frac = s.rpartition(".")
            if base and len(frac) == 3:
                s = f"{base}.{frac}000"
        try:
            d = _dt.datetime.strptime(s, py_fmt).replace(tzinfo=tzinfo)
            out[i] = int(d.timestamp() * 1000)
        except ValueError:
            out[i] = np.iinfo(np.int64).min  # unparseable -> placeholder
    return out


DICT_FNS["fromdatetime"] = _from_datetime


def to_datetime(ms, fmt: str, tz_name: Optional[str] = None):
    """TODATETIME(epochMillis, fmt[, tzId]) -> formatted string
    (host/selection path; strings never materialize on device)."""
    import datetime as _dt

    tzinfo = _dt.timezone.utc
    if tz_name is not None and str(tz_name).upper() not in ("UTC", "GMT", "Z"):
        from zoneinfo import ZoneInfo

        tzinfo = ZoneInfo(str(tz_name))
    py_fmt = _java_fmt_to_strptime(str(fmt))
    out = np.empty(len(ms), dtype=object)
    for i, v in enumerate(np.asarray(ms)):
        d = _dt.datetime.fromtimestamp(int(v) / 1000, tz=tzinfo)
        # SSS = milliseconds: substitute into the FORMAT (a post-hoc string
        # replace corrupted outputs whose digits matched)
        fmt_i = py_fmt.replace("%f", f"{d.microsecond // 1000:03d}")
        out[i] = d.strftime(fmt_i)
    return out

STRING_RESULT_DICT_FNS = frozenset(
    {
        "upper", "lower", "trim", "ltrim", "rtrim", "reverse", "substr", "substring",
        "concat", "replace", "lpad", "rpad",
        "splitpart", "split_part", "repeat", "regexpextract", "regexp_extract",
        "regexpreplace", "regexp_replace", "urlencode", "urldecode", "encodeurl",
        "decodeurl", "md5", "sha", "sha256", "sha512", "tobase64", "frombase64", "chr",
    }
)


# user-registered string-result dict functions (register_dict_function)
_EXTRA_STRING_RESULT: set = set()


def string_result(expr) -> bool:
    """Does this dictionary-function expression produce STRING values?
    (Routes between the derived-string host paths and numeric device
    gathers; JSON_EXTRACT_SCALAR's result type is its literal argument.)"""
    if expr.op == "json_extract_scalar":
        lits = [a.value for a in expr.args if a.is_literal]
        return len(lits) >= 2 and str(lits[1]).upper() == "STRING"
    return expr.op in STRING_RESULT_DICT_FNS or expr.op in _EXTRA_STRING_RESULT


def is_dict_fn_expr(expr) -> bool:
    """CALL of a dictionary-domain function over exactly one column (plus
    literals) — the shape rewritable as derived[codes]."""
    from pinot_tpu_torch.query.ir import ExprKind

    if expr.kind is not ExprKind.CALL or expr.op not in DICT_FNS:
        return False
    col_args = [a for a in expr.args if not a.is_literal]
    return len(col_args) == 1 and col_args[0].is_column


def eval_dict_fn(expr, values: np.ndarray) -> np.ndarray:
    """Apply a dict-domain function to a dictionary's values array."""
    lits = [a.value for a in expr.args if a.is_literal]
    return DICT_FNS[expr.op](values, *lits)


# derived arrays keyed by (expr fingerprint, dictionary fingerprint): the
# planner's interval bound and the gathers would otherwise run the same
# O(cardinality) pass several times per plan
_DERIVED_CACHE: Dict[Any, np.ndarray] = {}
_DERIVED_CACHE_MAX = 256


def derived_for(expr, dictionary) -> np.ndarray:
    key = (expr.fingerprint(), dictionary.fingerprint())
    hit = _DERIVED_CACHE.get(key)
    if hit is not None:
        return hit
    out = eval_dict_fn(expr, dictionary.values)
    if len(_DERIVED_CACHE) >= _DERIVED_CACHE_MAX:
        _DERIVED_CACHE.pop(next(iter(_DERIVED_CACHE)))
    _DERIVED_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# Interval analysis: bound an integer expression's value range from column
# stats, to size expression group-by dimensions statically.
# ---------------------------------------------------------------------------
def expr_int_range(expr, segment) -> Optional[Tuple[int, int]]:
    """(lo, hi) bound of an integer-valued expression, or None if unbounded /
    non-integer.  Conservative: propagates column min/max through monotone
    integer ops; anything else returns None."""
    from pinot_tpu_torch.query.ir import ExprKind

    if expr.kind is ExprKind.LITERAL:
        if isinstance(expr.value, (int, np.integer)) and not isinstance(expr.value, bool):
            v = int(expr.value)
            return (v, v)
        return None
    if expr.kind is ExprKind.COLUMN:
        c = segment.column(expr.op)
        if c.data_type.is_string_like or c.stats.min_value is None:
            return None
        mn, mx = c.stats.min_value, c.stats.max_value
        if isinstance(mn, (int, np.integer)) and isinstance(mx, (int, np.integer)):
            return (int(mn), int(mx))
        return None
    op = expr.op
    args = [expr_int_range(a, segment) for a in expr.args if not a.is_literal]
    lits = [a.value for a in expr.args if a.is_literal]
    if op == "datetrunc" and len(args) == 1 and args[0] is not None and lits:
        lo, hi = args[0]
        unit = str(lits[0])
        unit_args, tz = _split_dt_args(lits[1:])
        in_ms = TIME_UNIT_MS[str(unit_args[0]).upper()] if unit_args else 1
        # the 5-arg outputTimeUnit division MUST mirror _date_trunc_args —
        # a millis-ranged GroupDim against seconds-valued rows decodes
        # garbage group keys
        out_div = TIME_UNIT_MS[str(unit_args[1]).upper()] if len(unit_args) > 1 else 1
        f = lambda x: int(date_trunc(unit, torch.tensor([x * in_ms], dtype=torch.int64))[0])
        if tz is not None:
            # local truncation near a bucket boundary can land one WHOLE
            # bucket below the UTC truncation (an instant just past the UTC
            # year start is still in the previous local year) — widen the
            # lower bound by the unit's span, the upper by the max zone
            # shift (over-approximation is safe for range sizing;
            # ±1 day only covers sub-day units)
            span = {
                "year": 366 * MS_DAY,
                "quarter": 92 * MS_DAY,
                "month": 31 * MS_DAY,
                "week": 7 * MS_DAY,
            }.get(unit.lower(), MS_DAY)
            # symmetric: zones AHEAD of UTC can truncate one whole bucket
            # ABOVE the UTC truncation too (Pacific/Auckland's
            # year boundary)
            return ((f(lo) - span) // out_div, (f(hi) + span) // out_div)
        return (f(lo) // out_div, f(hi) // out_div)
    if op in ("year", "quarter", "month", "week", "weekofyear", "day", "dayofmonth", "hour", "minute", "second") and len(args) == 1 and args[0] is not None:
        lo, hi = args[0]
        unit_args, tz = _split_dt_args(lits)
        in_ms = TIME_UNIT_MS[str(unit_args[0]).upper()] if unit_args else 1
        # YEAR is monotone in the epoch; cyclic parts use the full part range
        if op == "year":
            pad = MS_DAY if tz is not None else 0  # zone shift < a day
            glo = int(_extract("year", torch.tensor([lo * in_ms - pad], dtype=torch.int64))[0])
            ghi = int(_extract("year", torch.tensor([hi * in_ms + pad], dtype=torch.int64))[0])
            return (glo, ghi)
        return {
            "quarter": (1, 4),
            "month": (1, 12),
            "week": (1, 53),
            "weekofyear": (1, 53),
            "day": (1, 31),
            "dayofmonth": (1, 31),
            "hour": (0, 23),
            "minute": (0, 59),
            "second": (0, 59),
        }[op]
    if op in ("dayofweek",):
        return (1, 7)
    if op in ("dayofyear",):
        return (1, 366)
    if op in ("timeconvert", "datetimeconvert") and len(args) == 1 and args[0] is not None:
        lo, hi = args[0]
        f = DEVICE_FNS[op]
        glo = int(f(torch.tensor([lo], dtype=torch.int64), *lits)[0])
        ghi = int(f(torch.tensor([hi], dtype=torch.int64), *lits)[0])
        return (min(glo, ghi), max(glo, ghi))
    if op in ("arraylength", "cardinality") and len(expr.args) == 1 and expr.args[0].is_column:
        c = segment.column(expr.args[0].op)
        ml = getattr(c, "mv_lengths", None)
        if ml is not None and len(ml):
            return (0, int(ml.max()))
        return None
    if op == "geogrid":
        lits2 = [a.value for a in expr.args if a.is_literal]
        if lits2:
            n = 1 << int(lits2[-1])
            return (0, n * n - 1)
        return None
    # numeric dictionary-domain functions (LENGTH, STRPOS, FROMDATETIME...):
    # bound by evaluating the derived array over the dictionary itself
    if is_dict_fn_expr(expr) and not string_result(expr):
        col = next(a for a in expr.args if not a.is_literal).op
        c = segment.column(col)
        if c.has_dictionary and c.dictionary.cardinality:
            derived = derived_for(expr, c.dictionary)
            a = np.asarray(derived)
            if np.issubdtype(a.dtype, np.integer):
                # FROMDATETIME marks unparseable values with int64-min —
                # keeping it in the bound explodes the key space to 2^63
                #; such rows fall outside the dense table
                # and silently drop from expression group-bys (documented)
                ok = a != np.iinfo(np.int64).min
                if not ok.any():
                    return None
                return (int(a[ok].min()), int(a[ok].max()))
        return None
    if op in ("plus", "add", "minus", "sub", "times", "mult") and len(expr.args) == 2:
        ra = expr_int_range(expr.args[0], segment)
        rb = expr_int_range(expr.args[1], segment)
        if ra is None or rb is None:
            return None
        combos = [
            a_ * b_ if op in ("times", "mult") else (a_ + b_ if op in ("plus", "add") else a_ - b_)
            for a_ in ra
            for b_ in rb
        ]
        return (min(combos), max(combos))
    if op == "abs" and len(expr.args) == 1:
        r = expr_int_range(expr.args[0], segment)
        if r is None:
            return None
        lo, hi = r
        return (0 if lo <= 0 <= hi else min(abs(lo), abs(hi)), max(abs(lo), abs(hi)))
    if op == "mod" and len(expr.args) == 2 and expr.args[1].is_literal:
        m = expr.args[1].value
        if isinstance(m, (int, np.integer)) and m > 0:
            return (0, int(m) - 1)
        return None
    if op == "length" or (op in DICT_FNS and op not in STRING_RESULT_DICT_FNS):
        # numeric dict functions: bound by evaluating over the dictionary
        return None  # planner handles via derived arrays instead
    return None
