"""stream.qps: queries completed in the window over the window's seconds.
A per-layer reading: the host's speed moves it from run to run by more
than an end-to-end bound may allow."""
from port_bench.harness import stats


def read(obs):
    return stats.rate(obs["completed"], obs["seconds"])
