"""broker.self_ms: the median, over the window's traced queries, of the
broker's own spans (plan + prune + reduce, children of the query's root
span in the broker's Trace)."""
from port_bench.harness import stats

OWN = ("plan", "prune", "reduce")


def read(obs):
    per_query = [sum(c["ms"] for c in t.get("children", []) if c["name"] in OWN) for t in obs.get("traces", [])]
    return stats.median(per_query) if per_query else None
