"""The control of a cell's comparison, at the cell's own size: the plain
reference computed in float32 (every product and sum; the step below the
configuration's exact int64 sums) put in the program's place, judged as a
run's answers are judged.  Each seed prints one JSON line with the
numbers compared; the exact limit (0) has to refuse every one.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...]

Runs on the host's cores (numpy); the benchmark's own runs do not run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "port_bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import run  # noqa: E402
from port_bench.harness import cell as cellmod, compare  # noqa: E402


def readings(cell, seed: int) -> dict:
    exact, agg_at = run.reference_rows(cell, seed)
    low, _ = run.reference_rows(cell, seed, "float32")
    return compare.judge({q: {tuple(rows)} for q, rows in low.items()}, exact, agg_at)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cellmod.load(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed)
        limits = cell.config["limits"]
        r.update(workload=cell.name, seed=seed, seconds=time.perf_counter() - t,
                 refused=any(r[k] > limits[k] for k in limits))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
