"""latency_p95_ms: the nearest-rank 95th percentile of the same times."""
from port_bench.harness import stats


def read(obs):
    return stats.percentile(obs["latencies_ms"], 95) if obs["latencies_ms"] else None
