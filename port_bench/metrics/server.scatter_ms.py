"""server.scatter_ms: the median, over the window's traced queries, of the
broker's scatter span: the servers' execution as the broker waits on it."""
from port_bench.harness import stats


def read(obs):
    per_query = [c["ms"] for t in obs.get("traces", []) for c in t.get("children", []) if c["name"] == "scatter"]
    return stats.median(per_query) if per_query else None
