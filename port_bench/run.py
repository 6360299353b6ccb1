"""Run one cell of the benchmark of pinot_tpu_torch once, and print its
result as the last line of standard output.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration,
traffic, queries, reference and metric readers are files under
port_bench/ found by name.  A run makes the data from --seed, builds and
loads the system, warms up every query of the cell's mix, then measures
for --seconds with the traffic's closed-loop clients.  With --trace 0 it
reports the cell's end-to-end metrics; with --trace 1 its per-layer
metrics, read from the program's trace spans and counters and from a
torch.profiler session over the window's first PROFILE_SECONDS.  After the
window it judges every answer against the plain reference (`correct`).

It exits without a result when no CUDA card is there, or fewer than the
cell asks for, and when JAX or the JAX package is loaded once the window
has closed.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "pinot_tpu")
WARM_ROUNDS = 2  # every query of the mix twice, one at a time, before the window
PROFILE_SECONDS = 16.0  # the traced window's profiler session: its first seconds, some cycles of the mix a client


def log(event: str, **kw) -> None:
    print(json.dumps({"event": event, **kw}, default=str), file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _fix_caches() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port's
    own nvcc build goes to build/torch_kernels there by itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


class Card:
    """The device the run serves on: the program's default (the card), or
    the CPU where the benchmark's own tests drive a run."""

    def __init__(self, device=None):
        import torch

        self.torch, self.cpu = torch, device == "cpu"

    def sync(self) -> None:
        if not self.cpu:
            self.torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return 0 if self.cpu else int(self.torch.cuda.max_memory_allocated())

    def name(self) -> str:
        return "cpu" if self.cpu else self.torch.cuda.get_device_name(0)

    def free(self) -> None:
        if not self.cpu:
            self.torch.cuda.empty_cache()


def _warm(system, queries, prefix: str, rounds: int, card: Card) -> None:
    for r in range(rounds):
        for qid, sql in queries.items():
            t = time.perf_counter()
            system.query(prefix + sql)
            card.sync()
            log("warm", round=r, query=qid, ms=(time.perf_counter() - t) * 1e3)


def reference_rows(cell, seed: int, dtype: str = "exact"):
    """The plain reference's rows of the cell's queries, over every part,
    in worker processes: ({qid: rows}, {qid: the aggregate's position})."""
    from port_bench.harness import cell as cellmod, pool

    ref = cellmod.module("reference", cell.config["reference"])
    cfg = cell.config
    tasks = [(seed, cfg["scale_factor"], i, cfg["orders_per_part"], list(cell.queries), dtype)
             for i in range(cfg["parts"])]
    merged = ref.merge(pool.run(ref.part_task, tasks))
    return {q: ref.rows(q, *merged[q]) for q in cell.queries}, {q: ref.agg_index(q) for q in cell.queries}


def _profiled(seconds: float, recorder, box):
    """The traced window's profiler session: started here, before the
    clients (a session takes seconds to start), and stopped by the
    returned function, which the main thread runs once the clients have
    started: the window's first PROFILE_SECONDS."""
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    from port_bench.harness.profile import CLOCK

    prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()

    def during(_t0):
        want = min(PROFILE_SECONDS, seconds)
        with record_function(CLOCK):
            p0 = time.perf_counter()
        recorder.recording = True
        time.sleep(max(0.0, want - (time.perf_counter() - p0)))
        recorder.recording = False
        p1 = time.perf_counter()
        prof.stop()
        box.update(prof=prof, p0=p0, p1=p1)

    return during


def run_cell(cell, seed: int, seconds: float, trace: int, device=None, wrap=None) -> dict:
    """One run of a cell; returns the result line's object (None when JAX
    or the JAX package got loaded).  device="cpu" and wrap (a function
    that wraps the system's query callable, to plant a fault) serve the
    benchmark's own tests."""
    from port_bench.harness import cell as cellmod, compare, launches, load, peaks, profile, spans

    card = Card(device)
    traffic = cell.traffic
    chips = int(cell.workload["chips"])
    log("cell", workload=cell.name, seed=seed, seconds=seconds, trace=trace, clients=traffic["clients"],
        queries=list(cell.queries))
    system = cellmod.module("systems", cell.config["system"]).System(cell.config, seed, log, device=device)
    query = wrap(system.query) if wrap else system.query
    prefix = "SET trace = true; " if trace else ""
    t_warm = time.perf_counter()
    _warm(system, cell.queries, prefix, WARM_ROUNDS, card)
    # the set-up's objects out of the collector's way: a full collection in
    # the window walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    log("setup", setup_s=setup_s, warm_s=time.perf_counter() - t_warm, residency=system.residency())

    from pinot_tpu_torch.ops import fused_scan

    before = {"fused_scan.launches": fused_scan.LAUNCHES}
    recorder = tap = during = None
    box = {}
    if trace:
        recorder, tap = launches.LaunchRecorder(), spans.SpanTap()
        tap.recording = True
        during = _profiled(seconds, recorder, box)

    def keep(out):
        return compare.canonical(out.rows), getattr(out.stats, "trace", None)

    try:
        records, _t0, t_end = load.closed_loop(query, keep, cell.queries, int(traffic["clients"]), seed, seconds,
                                               prefix, during)
    finally:
        if trace:
            recorder.remove()
            tap.remove()
    memory_peak = card.peak_bytes()
    after = {"fused_scan.launches": fused_scan.LAUNCHES}
    bad = forbidden_modules()
    if bad:
        print(f"no result: {bad} loaded in the benchmark's process", file=sys.stderr)
        return None

    in_window = [r for r in records if r.done <= t_end]
    obs = {
        "seconds": seconds,
        "setup_s": setup_s,
        "latencies_ms": [(r.done - r.sent) * 1e3 for r in in_window if r.error is None],
        "completed": sum(1 for r in in_window if r.error is None),
        "started": len(records),
        "counters": {k: after[k] - before[k] for k in after},
        "device_name": card.name(),
    }
    obs["peaks"] = peaks.PEAKS.get(obs["device_name"])
    breakdown = None
    if trace:
        obs["traces"] = [r.trace for r in in_window if r.trace is not None]
        summary = profile.summarize(box["prof"], box["p1"] - box["p0"], recorder.launches, tap.spans, box["p0"],
                                    [(r.qid, r.sent, r.done) for r in records])
        summary["least_bytes"] = recorder.total()
        summary["queries"] = sum(1 for r in records if box["p0"] <= r.done <= box["p1"])
        obs["profile"] = summary
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        log("profile", **{k: v for k, v in summary.items() if k not in ("device_ops", "idle_gaps")})
        box.clear()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cellmod.reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    log("window", queries=len(records), in_window=len(in_window), errors=sum(1 for r in records if r.error),
        memory_peak_bytes=memory_peak, counters=obs["counters"])

    # judge every answer once the program's state is freed
    gc.unfreeze()
    system.close()
    del system, query
    gc.collect()
    card.free()
    t_ref = time.perf_counter()
    reference, agg_at = reference_rows(cell, seed)
    answers = {}
    for r in records:
        if r.error is None:
            answers.setdefault(r.qid, set()).add(r.rows)
    judged = compare.judge(answers, reference, agg_at)
    wrong = {(q, a) for q, seen in answers.items() for a in seen
             if compare.compare(a, reference[q], agg_at[q]) != (0, 0.0)}
    failed = sum(1 for r in records if r.error is not None or (r.qid, r.rows) in wrong)
    log("reference", seconds=time.perf_counter() - t_ref, answers_compared=judged["answers_compared"],
        errors=sorted({r.error for r in records if r.error})[:5])
    limits = cell.config["limits"]
    checks = {k: {"value": judged[k], "limit": limits[k]} for k in limits}
    correct = bool(records) and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "cpu" if card.cpu else "gpu", "kind": obs["device_name"], "count": chips,
                   "memory_peak_bytes": memory_peak},
    }
    if trace:
        result["device"]["busy_s"] = obs["profile"]["busy_s"]
        result["device"]["window_s"] = obs["profile"]["window_s"]
        result["breakdown"] = breakdown
    checks["failed_queries"] = {"value": failed, "limit": 0}
    result["compared"] = checks
    for k, c in checks.items():
        print(f"compared {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fix_caches()

    from port_bench.harness import cell as cellmod

    cell = cellmod.load(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, args.trace)
    if result is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    _stop_resource_tracker()
    return 0


def _stop_resource_tracker() -> None:
    """End the helper process multiprocessing started for the shared
    memory, and wait for it, so the run leaves no process behind."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


if __name__ == "__main__":
    sys.exit(main())
