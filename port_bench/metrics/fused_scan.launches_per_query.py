"""fused_scan.launches_per_query: the fused scan's launch counter
(ops/fused_scan.py LAUNCHES) over the queries the traced window started."""


def read(obs):
    return obs["counters"]["fused_scan.launches"] / obs["started"] if obs["started"] else None
