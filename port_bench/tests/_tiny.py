"""A cell of BENCHMARK.json cut to a size a CPU test holds: scale factor
1's dimension tables and 2 parts of 3,000 orders (about 24,000 rows)."""
import dataclasses
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from port_bench.harness import cell as cellmod  # noqa: E402

SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's seeds are
TINY = {"scale_factor": 1, "parts": 2, "orders_per_part": 3000}


def tiny(workload: str):
    c = cellmod.load(workload)
    return dataclasses.replace(c, config=dict(c.config, **TINY))
