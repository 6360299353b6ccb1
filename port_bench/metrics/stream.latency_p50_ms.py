"""stream.latency_p50_ms: the median, over every query completed in the
window, of the time from the client's send to its rows.  A per-layer
reading: the median falls on the light queries, whose host path the
host's speed moves from run to run."""
from port_bench.harness import stats


def read(obs):
    return stats.median(obs["latencies_ms"]) if obs["latencies_ms"] else None
