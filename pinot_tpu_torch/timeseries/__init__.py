"""Timeseries query engine (pinot-timeseries analog)."""
from pinot_tpu_torch.timeseries.engine import (
    FetchNode,
    SeriesAggregateNode,
    TimeBuckets,
    TimeSeriesBlock,
    TimeSeriesEngine,
    TransformNode,
    parse_pipeline,
)

__all__ = [
    "FetchNode",
    "SeriesAggregateNode",
    "TimeBuckets",
    "TimeSeriesBlock",
    "TimeSeriesEngine",
    "TransformNode",
    "parse_pipeline",
]
