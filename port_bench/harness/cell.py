"""A cell, found by name: its entry of BENCHMARK.json, its configuration's
file, its traffic file, its query set and its metrics' readers.  A later
cell adds files and entries; none of this code needs to change for it."""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]  # port_bench/
REPO = BENCH.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict  # the configuration's file
    traffic: dict  # the traffic file
    queries: Dict[str, str]  # query id -> SQL, in file order
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # with --trace 1


def read_queries(name: str) -> Dict[str, str]:
    """A query set: each query follows a line '-- <id>' with no space in
    the id; other comment lines are skipped."""
    out: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for line in (BENCH / "queries" / f"{name}.sql").read_text().splitlines():
        s = line.strip()
        if s.startswith("--"):
            word = s[2:].strip()
            if word and " " not in word:
                cur = word
                out[cur] = []
            continue
        if s and cur is not None:
            out[cur].append(s)
    return {q: " ".join(lines) for q, lines in out.items()}


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, bench_file: Path = REPO / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_file.read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {bench_file.name}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((REPO / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    queries = read_queries(config["queries"])
    wanted = traffic.get("queries")
    if wanted:
        missing = [q for q in wanted if q not in queries]
        if missing:
            raise KeyError(f"traffic {w['traffic']} names queries {missing} not in {config['queries']}")
        queries = {q: queries[q] for q in wanted}
    return Cell(
        name=name, workload=w, config=config, traffic=traffic, queries=queries,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def module(kind: str, name: str):
    """port_bench.<kind>.<name>: a system or a reference module."""
    return importlib.import_module(f"port_bench.{kind}.{name}")


def reader(metric: str):
    """The reader of one metric, port_bench/metrics/<metric>.py (a metric's
    name may hold dots, so it is loaded from its path)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
