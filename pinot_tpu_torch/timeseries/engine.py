"""Timeseries engine: time-bucketed series over the SQL engine.

Reference parity: the pinot-timeseries SPI (pinot-timeseries/
pinot-timeseries-spi/.../tsdb/spi/ — TimeSeriesLogicalPlanner, TimeBuckets,
series blocks) with language plugins (M3QL) planned into a logical tree and
executed over the MSE runtime (TimeSeriesRequestHandler).

Re-design: the leaf fetch compiles to an ordinary SQL group-by whose time
dimension is the bucketed epoch — `GROUP BY tags, (ts - start) - MOD(ts -
start, step)` is a bounded computed key, so on either port engine it reaches
the CUDA fused scan through the expression group-by — and the series
operators (sumSeries/avgSeries/maxSeries/minSeries, scale/offset) are host
numpy over [num_buckets]-sized series.  Copy of
pinot_tpu/timeseries/engine.py (host-only): the same plan over the same
engine answer gives the same series.  The pipe language here is an M3QL-shaped
built-in; other languages implement plan() -> node tree (the SPI surface).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TimeBuckets:
    """Aligned evaluation window (TimeBuckets.java analog)."""

    start_ms: int
    step_ms: int
    num: int

    @property
    def end_ms(self) -> int:
        return self.start_ms + self.step_ms * self.num

    def bucket_of(self, ts_ms: int) -> int:
        return (int(ts_ms) - self.start_ms) // self.step_ms

    def timestamps(self) -> List[int]:
        return [self.start_ms + i * self.step_ms for i in range(self.num)]


@dataclass
class TimeSeriesBlock:
    """One operator's output: {tag tuple -> [num] values} (nan = no data)."""

    buckets: TimeBuckets
    tag_names: Tuple[str, ...]
    series: Dict[Tuple, np.ndarray]


# -- logical plan nodes (tsdb spi plan analog) ------------------------------
@dataclass
class FetchNode:
    table: str
    value_expr: str  # SQL expression aggregated per bucket, e.g. "v"
    agg: str = "sum"  # sum | count | min | max | avg
    filter_sql: str = ""  # SQL boolean expression
    group_tags: Tuple[str, ...] = ()
    time_column: str = "ts"


@dataclass
class SeriesAggregateNode:
    op: str  # sum | avg | max | min
    keep_tags: Tuple[str, ...] = ()
    child: object = None


@dataclass
class TransformNode:
    op: str  # scale | offset
    arg: float = 1.0
    child: object = None


class TimeSeriesEngine:
    """Executes a plan tree against any engine exposing .query(sql)."""

    def __init__(self, engine):
        self.engine = engine

    def execute(self, node, buckets: TimeBuckets) -> TimeSeriesBlock:
        if isinstance(node, FetchNode):
            return self._fetch(node, buckets)
        if isinstance(node, SeriesAggregateNode):
            return self._series_agg(node, self.execute(node.child, buckets))
        if isinstance(node, TransformNode):
            return self._transform(node, self.execute(node.child, buckets))
        raise TypeError(f"unknown plan node {type(node).__name__}")

    # -- leaf: SQL group-by over (tags, bucketed time) -------------------
    def _fetch(self, node: FetchNode, b: TimeBuckets) -> TimeSeriesBlock:
        tc = node.time_column
        # integer bucketing via arithmetic the expression group-by can bound:
        # (ts - start) - MOD(ts - start, step) is the bucket START offset
        off = f"({tc} - {b.start_ms})"
        bucket_expr = f"{off} - MOD({off}, {b.step_ms})"
        groups = list(node.group_tags) + [bucket_expr]
        where = f"{tc} >= {b.start_ms} AND {tc} < {b.end_ms}"
        if node.filter_sql:
            where = f"({node.filter_sql}) AND {where}"
        agg_sql = "COUNT(*)" if node.agg == "count" else f"{node.agg.upper()}({node.value_expr})"
        sql = (
            f"SELECT {', '.join(groups)}, {agg_sql} FROM {node.table} "
            f"WHERE {where} GROUP BY {', '.join(groups)} LIMIT 10000000"
        )
        res = self.engine.query(sql)
        nt = len(node.group_tags)
        series: Dict[Tuple, np.ndarray] = {}
        for row in res.rows:
            tags = tuple(row[:nt])
            arr = series.get(tags)
            if arr is None:
                arr = series[tags] = np.full(b.num, np.nan)
            bucket = int(row[nt]) // b.step_ms
            if 0 <= bucket < b.num:
                arr[bucket] = float(row[nt + 1])
        return TimeSeriesBlock(b, tuple(node.group_tags), series)

    # -- series combinators ----------------------------------------------
    @staticmethod
    def _series_agg(node: SeriesAggregateNode, block: TimeSeriesBlock) -> TimeSeriesBlock:
        keep_idx = [block.tag_names.index(t) for t in node.keep_tags]
        grouped: Dict[Tuple, List[np.ndarray]] = {}
        for tags, arr in block.series.items():
            key = tuple(tags[i] for i in keep_idx)
            grouped.setdefault(key, []).append(arr)
        out: Dict[Tuple, np.ndarray] = {}
        for key, arrs in grouped.items():
            m = np.vstack(arrs)
            with np.errstate(all="ignore"):
                if node.op == "sum":
                    vals = np.nansum(m, axis=0)
                    vals[np.all(np.isnan(m), axis=0)] = np.nan
                elif node.op == "avg":
                    vals = np.nanmean(m, axis=0)
                elif node.op == "max":
                    vals = np.nanmax(m, axis=0)
                else:
                    vals = np.nanmin(m, axis=0)
            out[key] = vals
        return TimeSeriesBlock(block.buckets, tuple(node.keep_tags), out)

    @staticmethod
    def _transform(node: TransformNode, block: TimeSeriesBlock) -> TimeSeriesBlock:
        f = (lambda a: a * node.arg) if node.op == "scale" else (lambda a: a + node.arg)
        return TimeSeriesBlock(
            block.buckets, block.tag_names, {k: f(v) for k, v in block.series.items()}
        )


# -- built-in pipe language (M3QL-shaped) -----------------------------------
_FETCH_RX = re.compile(r"(\w+)\s*=\s*(?:'([^']*)'|\"([^\"]*)\"|(\S+))")


def parse_pipeline(text: str):
    """`fetch table=t value=v agg=sum filter='...' tags=city,dept time=ts
        | sumSeries city | scale 2` -> plan tree (language-plugin analog)."""
    stages = [s.strip() for s in text.split("|") if s.strip()]
    if not stages or not stages[0].startswith("fetch"):
        raise ValueError("pipeline must start with `fetch`")
    kv = {m.group(1): (m.group(2) or m.group(3) or m.group(4)) for m in _FETCH_RX.finditer(stages[0][5:])}
    if "table" not in kv or "value" not in kv:
        raise ValueError("fetch needs table= and value=")
    node: object = FetchNode(
        table=kv["table"],
        value_expr=kv["value"],
        agg=kv.get("agg", "sum"),
        filter_sql=kv.get("filter", ""),
        group_tags=tuple(t for t in kv.get("tags", "").split(",") if t),
        time_column=kv.get("time", "ts"),
    )
    for stage in stages[1:]:
        parts = stage.split()
        op = parts[0].lower()
        if op in ("sumseries", "avgseries", "maxseries", "minseries"):
            node = SeriesAggregateNode(op[:-6], tuple(parts[1:]), child=node)
        elif op in ("scale", "offset"):
            node = TransformNode(op, float(parts[1]), child=node)
        else:
            raise ValueError(f"unknown pipeline stage {op!r}")
    return node
