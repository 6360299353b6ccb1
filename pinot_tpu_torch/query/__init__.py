

# The aggregation registry first: functions.py registers the sketch and
# extended families (sketches, aggs_extra, aggs_stats) at its bottom, and
# they import each other's helpers, so importing one of them first would
# meet a partly initialized module.
from pinot_tpu_torch.query import functions  # noqa: E402,F401
